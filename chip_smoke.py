#!/usr/bin/env python3
"""Run the PyTorch/CUDA port's main path on one CUDA card and check its kernels.

    python3 chip_smoke.py        # from the repository root, on a machine with a card

Phases, each printing one JSON line (any failure raises and exits non-zero):

0. the card (``nvidia-smi`` name and power limit), torch and CUDA versions;
1. build of every CUDA kernel of the path from ``csrc/`` (seconds, ptxas log:
   registers, shared memory, spills; K2's instantiations apart); then
   ``trsm_rowblock``: the row-block triangular-solve kernel against its
   plain version and cuBLAS at the cells' shapes (:func:`trsm_rowblock_phase`);
   and ``normal_matrix``: the equilibrated normal-matrix kernel of the
   ``'normal'`` step against its plain version and the einsum assembly it
   replaces at Burgers' shapes (:func:`normal_matrix_phase`);
2. the Gram kernel K1 against its plain PyTorch version on the card, one
   block per launch: 10 kernel x operator-pair cases at 1500 x 700 plus a
   ragged 33 x 17 case, in f32 (limit 1e-5 of the block's scale) and f64
   (1e-12); and the f32 exponential's error in ulp over q in [0, 87]
   (limit 4); then whole matrices in one launch on ragged point sets
   (65 + 33 + 7 points, five observables): the training Gram and a
   cross-Gram against the plain per-block assembly, block by block, in f32
   and f64, Theta exactly symmetric, and a Theta written into a strided
   slot of a larger buffer;
3. the canonical solve (the JAX package's N=900 draw, f32, nugget 1e-5,
   4 GN steps, extension to a 60x60 grid): a cold run, then a warm run
   timed with ``torch.cuda.synchronize()``, whose K1 launches must be
   exactly 2 (the training Gram and the test cross-Gram) and whose test L2
   must pass the 3.402e-3 gate, and five more warm runs for the spread;
   then those two one-launch assemblies, checked against the plain
   assembly in f32 and f64 and timed (device ms, the wrapper's host
   microseconds per call, the bound);
4. the largest dense solve (16,200 Gram rows: N_domain 7800, N_boundary
   600 from the port's sampler, seed 0): the problem is built and timed
   apart, then a cold solve, then a warm solve with its K1 launches (2),
   memory peak and the same gate, and two more warm solves for the spread;
   then its two assemblies and the 7,800^2 Laplacian x Laplacian block as
   a one-block launch, checked and timed the same way;
5. the other three reference workloads (``nonlinpdes_gpsolver_tpu_torch/
   workloads.py``: Burgers 1000/200, Eikonal 1000/200, the Darcy inverse
   400/100/60, each on the JAX package's draw, f32): a cold solve, a warm
   one with its K1 launches (2, 2 and 4: each training Gram and each test
   cross-Gram), memory peak and gate, three more warm solves; then each
   training Gram and cross-Gram checked against the plain assembly in f32
   and f64 and timed;
6. the Krylov steps: ``'cg'`` and ``'woodbury'`` against ``'direct'`` on the
   JAX package's Krylov test fixtures, gated in f64, reported in f32, and
   woodbury's inner iterations warm-started (:func:`krylov_steps`);
7. ``gn_graphs``: the Gauss-Newton loop recorded as CUDA graphs and
   replayed, against its steps run eagerly on the card (:func:`gn_graphs`):
   the canonical solve (``'structured'`` and ``'direct'``), phase 4's
   16,200 rows, the Darcy inverse workload, the Krylov fixtures of phase 6 in f64 and phase 9's
   42,500-row problem on the mesh path (``'cg'``): the dense replays
   bitwise the eager runs', the mesh one within 1e-5 of z's scale; the
   replay alone under ``torch.cuda.set_sync_debug_mode("error")``; the
   capture ms, replays, host reads, graph pool bytes and seconds of both;
8. ``k2_vs_plain``: K2 (the equilibrated strip kernel) against its
   plain version on every superblock window of a 5,000-row elliptic layout
   and on Darcy u layouts, f32 and f64, one launch each, exact unit
   diagonal, nothing written outside the slot; timed; and K2 on a rank's
   block-cyclic rows (rank-mapped plans: ranks 0 and 1 of 2, rank 3 of 4)
   the same way (:func:`k2_vs_plain`);
9. ``mesh_solve``: ``workloads.mesh_elliptic`` (42,500 Gram rows) through
   plain ``GPSolver(problem, nugget=1e-5)``, which ``auto_mesh`` must route
   to the mesh path: cold, warm (K1 and K2 launches, peak memory) and two
   more solves, phase seconds, superblocks and attempts, rungs, probe
   quality, CG iterations and the device ms of one kernel solve, gate
   3.402e-3; then each of its 21 K2 windows and its K1 launches checked
   against their plain versions and timed (K2: the sum's share of the
   bound and each window's, least and most, as in phase 8);
10. ``mesh_vs_dense``: phase 4's 16,200-row problem through
   ``mesh=make_mesh(1)``, cold and warm, beside the dense path's seconds
   (the card's datum on ``_AUTO_MESH_GRAM_ROWS``), same gate, its K2
   windows and K1 launches timed;
11. ``mesh_darcy``: ``workloads.darcy_past_wall`` (N_d 3,000) under its gates,
    its routed step solver (``'woodbury'``), deflation rank, CG iterations,
    memory and seconds, its K2 windows and K1 launches timed;
12. ``mesh_steps``: every step solver of the mesh path against the dense
    ``'direct'`` step on the JAX package's mesh-test fixtures, gated in
    f64 (:func:`mesh_steps`);
13. ``mesh_ranks``: two spawned ranks sharing the card over gloo, every
    collective staged through host memory (:func:`mesh_ranks`): each
    rank's rank-mapped K2 windows of ``mesh_elliptic`` checked and timed,
    ``mesh_elliptic`` routed to ``'cg'`` (cold, then warm: launches, peak
    memory a rank, factorize and GN seconds) and ``darcy_past_wall`` with
    ``'woodbury'`` under their gates, test L2 within 10% of phases 9 and
    11, z beside phase 9's, and the five step solvers of phase 12 in f64;
14. ``mesh_nccl``: one rank per visible card over NCCL (:func:`mesh_nccl`),
    phase 10's 16,200-row problem under its gate, z beside phase 10's, the
    loop recorded with its NCCL collectives inside: the replay against the
    eager loop bitwise (host reads, agreements, collectives of each), and
    a second problem that rebinds with no capture, bitwise its unshared
    solve, and a third live problem, a guest on every rank, its loop
    recorded on the guest entry with its collectives, bitwise its unshared
    solve; on a machine with one card, a group of one, and it says so;
15. ``checkpoint``: (a) phase 3's canonical factor and 4-step state
    through ``utils/checkpoint.py`` (the JAX package's file format): the
    factor, inverse and z bitwise, 2 GN steps resumed from the loaded z
    to at most 1.01 times the saved last loss, the extension through the
    reloaded factor equal to the original's in one K1 launch, under the
    gate; (b) phase 10's 16,200-row mesh factor and state saved, then
    reloaded in a child process that imports the port only
    (:func:`checkpoint_child`): the factor and its diagonal-block inverses
    bitwise, the whitened residual within 1e-6 of its scale, 2 resumed
    steps, the extension (K1 launches
    counted) under the gate; the file's bytes and the save and load seconds
    beside phase 10's factorize seconds;
16. ``compat``: the reference-API ``solver_GP`` flow on the card
    (:func:`compat_phase`): 2 K1 launches, under the gate;
17. ``perf_report``: the port's ``examples/perf_report.py`` as a
    subprocess, elliptic at 900 and 7,800 and ``--mesh 1`` at 7,800, warm:
    its table rows. Phases 4, 9 and 10 carry each phase's TFLOP/s by the
    JAX package's FLOP model (``flop_model_tflops``: the model's count,
    not a roofline share);
18. ``structure_reuse``: five new problems of one structure, each on a new
    ``GPSolver``, for the canonical problem (its draw, then fresh draws of
    the port's sampler), Burgers, Eikonal, Darcy, phase 4's 16,200 rows and
    phase 9's 42,500 (:func:`structure_reuse`; the last two on their
    phase's draw, then on fresh draws): the second binds the first one's
    storage and records its loop, later ones replay it with no capture;
    ``two_pass``: three of phase 4's problems on the mesh path's two-pass
    factorization, the second and third rebound; ``held``: six runs of the
    canonical, Darcy, 16,200- and 42,500-row cases, each run's solver and
    result kept until the next solve returns, bound made, made, then
    rebound, with no capture from the fifth; ``sweep``: the canonical,
    Darcy and 16,200-row cases six times and the 42,500-row case four
    times, every solver and result kept to the end, bound made, made, then
    guest (one copy of each guest's factors into the layout's guest
    entry), with no capture from the fifth (the 42,500-row Krylov loop
    from the fourth), at most three entries and graph pools, and one
    released entry once the results are gone; each run bitwise an
    unshared solve of the same problem (and, but for the held and sweep
    runs, its eager solve), under its gates. Phases 3-5 and 9 report how
    each repeat bound;
19. the script's seconds so far (the build included), the kernel summary
    line (K1 with its mesh-path, checkpoint and compat launches, K2 with
    its rank-mapped ones), then the card's name and power limit, and last
    ``{"ok": true, "device": {...}}``.

Bounds use the H100 SXM data sheet: 3.35 TB/s of HBM, 67 TFLOP/s in f32
and 34 TFLOP/s in f64 outside the tensor cores. Device times come from
CUDA events around back-to-back calls enqueued while the card sleeps, so
the host's launch cost does not enter them; the wrapper's host cost is
timed apart.
"""

import contextlib
import gc
import json
import math
import os
import re
import socket
import subprocess
import tempfile
import time

GATE_L2 = 3.402e-3  # BASELINE.md row 1, the bench.py accuracy gate
Z_REL_GATE = 1e-4  # z across ranks against one device, of z's scale (measured ~7e-6 in f32)
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"float32": 67e12, "float64": 34e12}
EXP_OPS = 25  # Cody-Waite exp: reduction, 7 Horner FMAs, exponent assembly
# K1 launches per solve: each block's training Gram and each extended block's
# test cross-Gram (Darcy: two blocks, both extended)
WORKLOAD_LAUNCHES = {"burgers": 2, "eikonal": 2, "darcy": 4}


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
    warm-up calls: CUDA events around the run, enqueued behind a sleep on
    the card so that the host's launch cost stays out of the reading."""
    import torch

    for _ in range(2):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    torch.cuda._sleep(50_000_000)  # ~25 ms of the card's clock: the host runs ahead
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def host_us(fn, reps):
    """Mean host microseconds to issue ``fn()`` (no synchronisation inside)."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    t = time.perf_counter() - t0
    torch.cuda.synchronize()
    return t / reps * 1e6


def k1_bound_ms(plan, dtype_name):
    """Least time for one K1 (or K2) launch of ``plan``: each output entry
    written once (mirrors included) and each input read once at the HBM
    rate (K2: the row and column scales too), against the operations of each
    distinct entry (the upper triangle of a symmetric block; K2: two more
    products an entry, none in fill blocks) at the peak rate. Returns (ms,
    "bytes"|"operations")."""
    esize = 4 if dtype_name == "float32" else 8
    dim = plan.kernel.dim
    a = plan._arrays
    written = sum(b.n * b.m * (2 if b.mirror else 1) for b in plan.blocks)
    read = sum(plan.set_sizes) * dim + a["inv_sq"].size + a["poly"].size + a["coef"].size
    if plan.equilibrated:
        read += sum(plan.shape)
    bytes_moved = esize * (written + read) + 4 * (a["degs"].size + a["blocks"].size)
    flops = 0
    for b in plan.blocks:
        if b.fill:
            continue
        per_entry = dim + 3 * dim + EXP_OPS + 1 + 2 * plan.equilibrated  # u, q, exp, products
        for row in plan.tables[b.table][1]:
            per_entry += 1 + sum(2 * int(d) + 1 for d in row if d > 0)  # Horner, products, sum
        flops += per_entry * (b.n * (b.n + 1) // 2 if b.symmetric else b.n * b.m)
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype_name] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def k2_ptxas(ptxas):
    """K2's instantiations in the ptxas lines, as ``{"K2<float, dim 2,
    mapped>": "registers ...; spills ..."}``."""
    out, name = {}, None
    for ln in ptxas:
        m = re.search(r"gram_equilibrated_kernelI([fd])Li(\d)ELb([01])", ln)
        if "entry function" in ln:
            name = m and (f"K2<{'float' if m[1] == 'f' else 'double'}, dim {m[2]}"
                          f"{', mapped' if m[3] == '1' else ''}>")
        elif name:
            out[name] = "; ".join(filter(None, [out.get(name), ln.split(": ", 1)[-1]]))
    return out


def blockwise_rel_err(plan, got, ref):
    """Largest |got - ref| over each block (and its mirror) relative to that
    block's scale, and the largest absolute difference (K2's fill blocks
    are held to exact equality apart)."""
    rel, diff_max = 0.0, 0.0
    for b in plan.blocks:
        if b.fill:
            continue
        slots = [(slice(b.row_off, b.row_off + b.n), slice(b.col_off, b.col_off + b.m))]
        if b.mirror:
            slots.append(slots[0][::-1])
        for rs, cs in slots:
            diff = float((got[rs, cs] - ref[rs, cs]).abs().max())
            rel = max(rel, diff / float(ref[rs, cs].abs().max()))
            diff_max = max(diff_max, diff)
    return rel, diff_max


def krylov_steps(tpt, dev):
    """``'cg'`` and ``'woodbury'`` against ``'direct'`` on the fixtures of
    the JAX package's Krylov tests, with their sizes and parameters
    (``tests/test_engine.py::test_gn_cg_matches_direct``: 120/32 elliptic,
    sigma 0.3, nugget 1e-10, cg_tol 1e-14; ``tests/test_distributed_solver.py``
    ``::_small_darcy``: 48/16 Darcy, sigma 0.4, observations
    ``linspace(0, 0.01, 12)``, noise 1e-2, nugget 1e-4, trsm, cg_tol 1e-9,
    cg_maxiter 2000), on points from the port's sampler with seed 0. Gated
    in f64: the elliptic 'cg' over 4 GN steps, Darcy's 'woodbury' over 3
    (as the JAX package's tests run it) and 'cg' over 2. Reported only:
    the inner iterations of woodbury's second step from zero and
    warm-started from the first step's solutions, and the same solves in
    f32, Darcy's with its inner
    solves capped at 50 iterations (f32 cannot reach cg_tol 1e-9 there, so
    every inner solve runs to its cap). A CG iteration costs some 5-10 ms
    of host time on the card, so the phase keeps its iteration counts low."""
    import torch

    from nonlinpdes_gpsolver_tpu_torch.solvers import gn

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize()

    def u(x):
        return torch.sin(torch.pi * x[0]) * torch.sin(torch.pi * x[1])

    def rhs(x):
        return -torch.trace(torch.func.hessian(u)(x)) + u(x) ** 3

    def points(n, nb, dtype):
        gen = torch.Generator(device=dev).manual_seed(0)
        return tpt.utils.sample_random(gen, n, nb, dtype=dtype)

    def elliptic(dtype):
        Xd, Xb = points(120, 32, dtype)
        k = tpt.SquaredExponential.gaussian(0.3)
        return tpt.factorize(tpt.models.nonlinear_elliptic(k, Xd, Xb, rhs, u, seed=2), 1e-10)

    def darcy(dtype):
        Xd, Xb = points(48, 16, dtype)
        k = tpt.SquaredExponential.gaussian(0.4)
        obs = torch.linspace(0.0, 0.01, 12, dtype=dtype, device=dev)
        prob = tpt.models.darcy_flow(k, k, Xd, Xb, obs, lambda x: torch.ones_like(x[0]),
                                     noise_level=1e-2, seed=3)
        return tpt.factorize(prob, 1e-4, solve_mode="trsm")

    def compare(fp, steps, ref=None, **kw):
        ref = ref or tpt.gn_solve(fp, max_iter=steps, step_solver="direct")
        sync()
        t0 = time.perf_counter()
        st = tpt.gn_solve(fp, max_iter=steps, **kw)
        sync()
        secs = time.perf_counter() - t0
        iters = st.cg_iters.tolist()
        row = {**kw, "z_abs_diff": float((st.z - ref.z).abs().max()),
               "z_rel_diff": float((st.z - ref.z).abs().max() / ref.z.abs().max()),
               "losses": st.losses.tolist(), "direct_losses": ref.losses.tolist(),
               "cg_iters": iters, "seconds": secs, "ms_per_cg_iter": secs / max(sum(iters), 1) * 1e3}
        return row, st, ref

    out = {}
    fp = elliptic(torch.float64)
    row, st, ref = compare(fp, 4, step_solver="cg", cg_tol=1e-14)
    out["f64_elliptic_cg"] = row
    check(row["z_abs_diff"] <= 5e-6, f"f64 elliptic cg: z differs by {row['z_abs_diff']:.3e}")
    dl = abs(row["losses"][-1] - row["direct_losses"][-1]) / row["direct_losses"][-1]
    check(dl <= 1e-6, f"f64 elliptic cg: last loss differs by {dl:.3e} (rtol)")
    fp = darcy(torch.float64)
    kw = dict(cg_tol=1e-9, cg_maxiter=2000)
    for solver, steps in (("woodbury", 3), ("cg", 2)):
        row = out[f"f64_darcy_{solver}"] = compare(fp, steps, step_solver=solver, **kw)[0]
        what = f"f64 darcy {solver}"
        check(all(0 < i < 2000 for i in row["cg_iters"]), f"{what}: cg_iters {row['cg_iters']}")
        check(row["z_rel_diff"] < 1e-5, f"{what}: z differs by {row['z_rel_diff']:.3e} (rel)")
        lr = max(abs(a - b) / abs(b) for a, b in zip(row["losses"], row["direct_losses"]))
        check(lr <= 1e-5, f"{what}: losses differ by {lr:.3e} (rtol)")
    # the second woodbury step's inner iterations, from zero and from the
    # first step's solutions (the mesh path's carry; gn_solve starts at zero)
    z = fp.problem.init_latent()
    step, first, X = gn._delta_woodbury(fp, z, 0.0, **kw)
    z = z - step
    out["f64_darcy_woodbury_warm"] = {
        "first_step_iters": int(first),
        "second_step_iters_cold": int(gn._delta_woodbury(fp, z, 0.0, **kw)[1]),
        "second_step_iters_warm": int(gn._delta_woodbury(fp, z, 0.0, X0=X, **kw)[1]),
    }
    fp = elliptic(torch.float32)
    out["f32_elliptic_cg"] = compare(fp, 4, step_solver="cg", cg_tol=1e-14)[0]
    fp = darcy(torch.float32)
    ref = None
    for solver in ("woodbury", "cg"):
        out[f"f32_darcy_{solver}"], _, ref = compare(fp, 2, ref, step_solver=solver,
                                                     cg_tol=1e-9, cg_maxiter=50)
    return out


# The triangular solves of the Woodbury step's CG iteration (Darcy 3,000: the
# u and phi factors, 61 columns) and a one-column solve on Burgers' factor,
# all on blocks of 512 rows, GPSolver's default
TRSM_CASES = (("darcy_u", 12750, 61), ("darcy_phi", 9000, 61), ("burgers", 21000, 1))


def trsm_factor(tpt, dev, n, block=512, seed=0):
    """A P = 1 factor of ``n`` rows in ``block``-row blocks, float32, of a
    well-conditioned SPD matrix (``G G^T / n + I``, ``G`` Gaussian:
    condition about 5), built as the mesh path builds one (f64 Cholesky,
    refined diagonal-block inverses)."""
    import torch

    g = torch.Generator(device=dev).manual_seed(seed)
    G = torch.randn((n, n), generator=g, device=dev)
    A = G @ G.T / n
    A.diagonal().add_(1.0)
    del G
    return tpt.parallel.cholesky_blockcyclic(A, tpt.parallel.make_mesh(1, device=dev), block=block)


def trsm_rowblock_phase(tpt, dev, cases=TRSM_CASES, reps=20):
    """Phase ``trsm_rowblock``: the row-block kernel against its plain
    version and ``torch.linalg.solve_triangular`` (``library_ms``, cuBLAS)
    at the cells' shapes, forward and transposed: each one's error against
    a float64 solve, two launches bitwise equal, device ms, and the bound
    (reading the lower triangle once at the HBM rate against ``n^2 k``
    flops at the f32 FFMA rate)."""
    import torch
    from nonlinpdes_gpsolver_tpu_torch.ops import trsm_rowblock as tr

    rows, launches = [], tr.LAUNCHES
    for name, n, k in cases:
        fac = trsm_factor(tpt, dev, n)
        L, W, n_pad = fac.matrix, fac.diag_inv, fac.n_pad
        V = torch.randn((n, k), generator=torch.Generator(device=dev).manual_seed(1), device=dev)
        Vp = torch.zeros((n_pad, k), device=dev)
        Vp[:n] = V
        L64 = L.double()
        for trans in (False, True):
            before = tr.LAUNCHES
            got = tr.trsm_rowblock(L, W, V, trans)
            again = tr.trsm_rowblock(L, W, V, trans)
            torch.cuda.synchronize()
            check(tr.LAUNCHES - before == 2, f"trsm {name}: {tr.LAUNCHES - before} launches")
            check(torch.equal(got, again), f"trsm {name} trans={trans}: two launches differ")
            plain = tr.trsm_rowblock_plain(L, W, V, trans)
            lib = torch.linalg.solve_triangular(L.mT if trans else L, Vp, upper=trans)
            truth = torch.linalg.solve_triangular(L64.mT if trans else L64, Vp.double(), upper=trans)
            scale = float(truth.abs().max())

            def err(x):
                return float((x.double() - truth).abs().max()) / scale

            e_kernel, e_plain, e_lib = err(got), err(plain), err(lib)
            check(math.isfinite(e_kernel) and e_kernel <= min(4 * max(e_lib, e_plain), 50 * 2.0**-23),
                  f"trsm {name} trans={trans}: kernel error {e_kernel:.3e}, cuBLAS {e_lib:.3e}, "
                  f"plain {e_plain:.3e}")
            ms = time_ms(lambda: tr.trsm_rowblock(L, W, V, trans), reps)
            plain_ms = time_ms(lambda: tr.trsm_rowblock_plain(L, W, V, trans), max(2, reps // 4))
            lib_ms = time_ms(lambda: torch.linalg.solve_triangular(L.mT if trans else L, Vp,
                                                                   upper=trans), reps)
            flops = n_pad * n_pad * k
            nbytes = 4 * (n_pad * n_pad // 2 + n_pad * tr.STEP // 2 + 2 * n_pad * k)
            t_ops = flops / PEAK_FLOPS["float32"] * 1e3
            t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
            rows.append({"case": name, "n": n, "n_pad": n_pad, "k": k, "block": fac.block,
                         "trans": trans, "ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
                         "bound_ms": max(t_ops, t_bytes), "bound_ops_ms": t_ops,
                         "bound_bytes_ms": t_bytes,
                         "bound_by": "operations" if t_ops >= t_bytes else "bytes",
                         "roofline_pct": 100 * max(t_ops, t_bytes) / ms,
                         "rel_err": e_kernel, "plain_rel_err": e_plain, "library_rel_err": e_lib,
                         "bitwise_repeat": True})
        del fac, L, W, L64
        gc.collect()
        torch.cuda.empty_cache()
    return {"launches": tr.LAUNCHES - launches, "cases": rows}


# The 'normal' step's blocks: Burgers' cell (5,000 interior points, four live
# segments, three latent slices) and a ragged shape (N not a multiple of 4)
NORMAL_CASES = (("burgers", 3, 4, 5000), ("ragged", 3, 4, 1001))


def normal_matrix_phase(tpt, dev, cases=NORMAL_CASES, reps=20):
    """Phase ``normal_matrix``: the equilibrated normal-matrix kernel
    (``ops/normal_matrix.py``) on a symmetric positive definite inverse
    block (``G G^T / 64 + I/2``) and Gaussian diagonals: its gap to the
    plain version in float64, exactly symmetric, the floored diagonal, two
    launches bitwise; device ms of the kernel, of the scales' pass
    (``normal_diagonal`` and the ``rsqrt``), of the plain version and of the
    einsum assembly and equilibration it replaces (``einsum_ms``:
    ``einsum_normal_matrix`` and ``ops/linalg.py::equilibrate_floored``); and
    the bound: the half of ``A`` that its symmetry leaves read once and the
    result written once at the HBM rate (``bound_ms``), beside ``A`` read
    whole (``bound_full_read_ms``)."""
    import torch
    from nonlinpdes_gpsolver_tpu_torch.ops import normal_matrix as nm
    from nonlinpdes_gpsolver_tpu_torch.ops.linalg import equilibrate_floored

    rows, launches = [], nm.LAUNCHES
    for name, s, S, N in cases:
        g = torch.Generator(device=dev).manual_seed(N)
        G = torch.randn((S * N, 64), generator=g, device=dev)
        A = G @ G.T / 64
        A.diagonal().add_(0.5)
        A4 = A.view(S, N, S, N)
        del G
        Dl = torch.randn((s, S, N), generator=g, device=dev)
        pairs = [(A4, Dl)]
        sc = torch.rsqrt(nm.normal_diagonal(pairs))
        before = nm.LAUNCHES
        got = nm.normal_matrix(pairs, sc)
        again = nm.normal_matrix(pairs, sc)
        torch.cuda.synchronize()
        check(nm.LAUNCHES - before == 2, f"normal_matrix {name}: {nm.LAUNCHES - before} launches")
        check(torch.equal(got, again), f"normal_matrix {name}: two launches differ")
        check(torch.equal(got, got.mT), f"normal_matrix {name}: not exactly symmetric")
        check(bool((got.diagonal() == nm.floor_value(torch.float32)).all()),
              f"normal_matrix {name}: diagonal not floored")
        del again
        ref = nm.normal_matrix_plain([(A4.double(), Dl.double())], sc.double())
        gap = float((got.double() - ref).abs().max() / ref.abs().max())
        del ref
        plain32 = nm.normal_matrix_plain(pairs, sc)
        plain_gap = float((plain32 - got).abs().max())
        del plain32
        check(math.isfinite(gap) and gap <= 2e-5, f"normal_matrix {name}: gap {gap:.3e} to float64")
        m = s * N

        def einsum_form():
            return equilibrate_floored(nm.einsum_normal_matrix(pairs, (), sc))[0]

        Hs = einsum_form()
        einsum_gap = float((Hs - got).abs().max())
        del Hs, got
        gc.collect()
        torch.cuda.empty_cache()
        ms = time_ms(lambda: nm.normal_matrix(pairs, sc), reps)
        scales_ms = time_ms(lambda: torch.rsqrt(nm.normal_diagonal(pairs)), reps)
        plain_ms = time_ms(lambda: nm.normal_matrix_plain(pairs, sc), 2)
        einsum_ms = time_ms(einsum_form, 3)
        nbytes = 4 * (S * S * N * (N + 1) // 2 + m * m)
        full_bytes = 4 * (S * S * N * N + m * m)
        flops = 2 * N * N * (S * S * s + s * s * S)
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = flops / PEAK_FLOPS["float32"] * 1e3
        rows.append({"case": name, "s": s, "S": S, "N": N, "ms": ms, "scales_ms": scales_ms,
                     "plain_ms": plain_ms, "einsum_ms": einsum_ms, "bound_ms": max(t_bytes, t_ops),
                     "bound_bytes_ms": t_bytes, "bound_ops_ms": t_ops,
                     "bound_full_read_ms": full_bytes / HBM_BYTES_PER_S * 1e3,
                     "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                     "roofline_pct": 100 * max(t_bytes, t_ops) / ms, "rel_err_f64": gap,
                     "max_abs_to_plain_f32": plain_gap, "max_abs_to_einsum_f32": einsum_gap,
                     "bitwise_repeat": True})
        del A, A4, Dl, pairs, sc
        gc.collect()
        torch.cuda.empty_cache()
    return {"launches": nm.LAUNCHES - launches, "cases": rows}


# mesh_steps' float32 'normal' step on a card, gated (of z's scale): elliptic
# against its float64 run (9.2e-4 where the kernel's arithmetic runs as its
# plain version on the CPU: the float32 factorization takes one nugget rung
# more), Darcy against the float32 'direct' step (1.5e-2 there; its
# equilibrated normal matrix sits at the 32 eps floor, condition ~2.6e5)
NORMAL_F32_TO_F64 = 1e-2
NORMAL_F32_TO_DIRECT = 5e-2


def mesh_steps(tpt, dev, mesh=None, dtypes=None):
    """Each step solver of the mesh path (on ``mesh``, default the card
    alone; ``dtypes`` default f64 and f32) against the dense ``'direct'``
    step, 3 GN steps, on the fixtures of the JAX package's mesh tests
    (``tests/test_distributed_solver.py``: ``_elliptic_problem``, 150/40,
    sigma 0.3, nugget 1e-10, here from z0 = 0, and ``_small_darcy``, 48/16,
    sigma 0.4, 12 observations on linspace(0, 0.01), noise 1e-2, nugget
    1e-4; woodbury at cg_tol 1e-9, cg_maxiter 2,000), on points from the
    port's sampler with seed 0, 16-row blocks. Gated in f64 (within 1e-6 of
    z's scale), reported in f32, but for the f32 ``'normal'`` step on a
    card, which runs eagerly (``graphs.uncaptured``) with the counters
    zeroed before it, and is gated: every assembly routed to the
    normal-matrix kernel (``ops/graphs.py::NORMAL_ASSEMBLIES``), one launch
    a block a step; elliptic's z within :data:`NORMAL_F32_TO_F64` of its
    f64 run's scale (the fixture starts from zero in both dtypes), Darcy's
    within :data:`NORMAL_F32_TO_DIRECT` of the f32 ``'direct'`` step's (its
    random start is drawn in the dtype, so the f64 run starts elsewhere).
    The elliptic fixture starts from zero: from
    its random start the first full step more than doubles the loss, so the
    mesh path's damped update halves it where the dense loop takes it
    (fault R3), and the two paths part by design."""
    import torch

    from nonlinpdes_gpsolver_tpu_torch.ops import graphs
    from nonlinpdes_gpsolver_tpu_torch.ops import normal_matrix as nm
    from nonlinpdes_gpsolver_tpu_torch.parallel import make_mesh
    from nonlinpdes_gpsolver_tpu_torch.solvers.distributed import (
        factorize_distributed, gn_solve_distributed,
    )

    mesh = make_mesh(1, device=dev) if mesh is None else mesh

    def u(x):
        return torch.sin(torch.pi * x[0]) * torch.sin(torch.pi * x[1])

    def rhs(x):
        return -torch.trace(torch.func.hessian(u)(x)) + u(x) ** 3

    def points(n, nb, dtype):
        return tpt.utils.sample_random(torch.Generator(device=dev).manual_seed(0), n, nb,
                                       dtype=dtype)

    def elliptic(dtype):
        Xd, Xb = points(150, 40, dtype)
        k = tpt.SquaredExponential.gaussian(0.3)
        return tpt.models.nonlinear_elliptic(k, Xd, Xb, rhs, u, init="zero"), 1e-10

    def darcy(dtype):
        Xd, Xb = points(48, 16, dtype)
        k = tpt.SquaredExponential.gaussian(0.4)
        obs = torch.linspace(0.0, 0.01, 12, dtype=dtype, device=dev)
        return tpt.models.darcy_flow(k, k, Xd, Xb, obs, lambda x: torch.ones_like(x[0]),
                                     noise_level=1e-2, seed=3), 1e-4

    fixtures = (("elliptic", elliptic, ("structured", "direct", "cg", "normal")),
                ("darcy", darcy, ("woodbury", "structured", "normal")))
    out, z64 = {}, {}
    for dtype in dtypes or (torch.float64, torch.float32):
        tag = str(dtype).split(".")[1]
        for name, build, solvers in fixtures:
            prob, nugget = build(dtype)
            ref = tpt.gn_solve(tpt.factorize(prob, nugget, solve_mode="trsm"), max_iter=3,
                               step_solver="direct")
            dfp = factorize_distributed(prob, mesh, nugget=nugget, block=16)
            for solver in solvers:
                kw = dict(cg_tol=1e-9, cg_maxiter=2000) if solver == "woodbury" else {}
                kernel = solver == "normal" and dtype == torch.float32 and dev.type == "cuda"
                if kernel:
                    graphs.reset_counts()
                    launches = nm.LAUNCHES
                sync(dev)
                t0 = time.perf_counter()
                with graphs.uncaptured() if kernel else contextlib.nullcontext():
                    st = gn_solve_distributed(dfp, max_iter=3, step_solver=solver, **kw)
                sync(dev)
                rel = float((st.z - ref.z).abs().max() / ref.z.abs().max())
                row = out[f"{tag}_{name}_{solver}"] = {
                    "z_rel_diff": rel, "losses": st.losses.tolist(),
                    "direct_losses": ref.losses.tolist(), "cg_iters": st.cg_iters.tolist(),
                    "seconds": time.perf_counter() - t0, "rungs": dfp.rungs,
                }
                if dtype == torch.float64:
                    check(rel <= 1e-6, f"mesh {solver} on {name}: z differs by {rel:.3e}")
                    z64[name, solver] = st.z
                if kernel:
                    row.update(assemblies=dict(graphs.NORMAL_ASSEMBLIES),
                               normal_launches=nm.LAUNCHES - launches, blocks=len(prob.blocks))
                    done = graphs.NORMAL_ASSEMBLIES["kernel"]
                    check(done >= 1 and graphs.NORMAL_ASSEMBLIES["einsum"] == 0
                          and row["normal_launches"] == done * len(prob.blocks),
                          f"mesh f32 normal on {name}: assemblies {row['assemblies']}, "
                          f"{row['normal_launches']} launches")
                    if name == "elliptic" and (name, solver) in z64:
                        ref64 = z64[name, solver]
                        row["z_rel_to_f64"] = float((st.z.double() - ref64).abs().max()
                                                    / ref64.abs().max())
                        check(row["z_rel_to_f64"] <= NORMAL_F32_TO_F64,
                              f"mesh f32 normal on {name}: z differs from f64 by "
                              f"{row['z_rel_to_f64']:.3e}")
                    elif name != "elliptic":
                        check(rel <= NORMAL_F32_TO_DIRECT,
                              f"mesh f32 normal on {name}: z differs from direct by {rel:.3e}")
    return out


def graph_pool_bytes(pool):
    """Bytes of the card's memory held by the graph pool ``pool`` (its
    segments in the allocator's snapshot)."""
    import torch

    return sum(seg["total_size"] for seg in torch.cuda.memory_snapshot()
               if tuple(seg.get("segment_pool_id", ())) == tuple(pool))


def replay_steps(tpt, fp, loop, z0, steps, mesh):
    """``steps`` Gauss-Newton steps of the recorded ``loop`` (which runs on
    the factored problem ``fp``: the entry's view of a bound problem) from
    ``z0``, as ``gn_solve`` (``mesh``: ``gn_solve_distributed``) runs them,
    without the call's set-up: for the replay under the sync debug mode."""
    from nonlinpdes_gpsolver_tpu_torch.ops.graphs import Flag
    from nonlinpdes_gpsolver_tpu_torch.solvers import distributed

    c = loop.carry
    with loop.rec.scope():
        c.reset(z0)
        if mesh:
            c.loss.copy_(fp.loss(z0))
        flag = Flag(z0.device)
        for _ in range(steps):
            loop.step(fp)
            if mesh:
                flag.post(c.code)
                if flag.read() & 1:
                    distributed._halve(fp, c, 1.0)
    return c.z.clone()


def gn_graph_case(tpt, fp, run, z0, steps, mesh=False):
    """One configuration of the Gauss-Newton loop (``run(fp)``: a
    ``gn_solve`` call on ``fp``) on the card: its steps run eagerly
    (``graphs.uncaptured``), then three calls with recording on (the first
    warms up: a Krylov loop records after its first step, an exact one
    runs eagerly; the second records an exact loop; the third only
    replays), then the replay alone under
    ``torch.cuda.set_sync_debug_mode("error")``. Seconds, host reads,
    replays and captures of each call; z of the replay against the eager
    run's."""
    import torch

    from nonlinpdes_gpsolver_tpu_torch.ops import graphs
    from nonlinpdes_gpsolver_tpu_torch.solvers._reuse import loops_of

    def timed():
        graphs.reset_counts()
        sync()
        t0 = time.perf_counter()
        st = run(fp)
        sync()
        return st, {"seconds": time.perf_counter() - t0, "host_reads": graphs.HOST_READS,
                    "replays": graphs.REPLAYS, "captures": graphs.CAPTURES,
                    "capture_ms": graphs.CAPTURE_SECONDS * 1e3,
                    "cg_iters": st.cg_iters.tolist()}

    with graphs.uncaptured():  # earlier phases ran these code paths: no warm-up
        eager, eager_row = timed()
    check(eager_row["captures"] == eager_row["replays"] == 0,
          "an uncaptured run recorded or replayed a graph")
    first, first_row = timed()
    second, second_row = timed()
    replayed, rep_row = timed()
    check(first_row["captures"] + second_row["captures"] > 0, "no graph was recorded")
    check(rep_row["captures"] == 0 and rep_row["replays"] > 0,
          f"the third run recorded {rep_row['captures']} graphs, replayed {rep_row['replays']}")
    loops, run_fp = loops_of(fp)
    loop = list(loops.values())[-1]
    torch.cuda.set_sync_debug_mode("error")
    try:
        z_debug = replay_steps(tpt, run_fp, loop, z0, steps, mesh)
        sync()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    return {
        "eager": eager_row, "first": first_row, "recorded": second_row, "replayed": rep_row,
        "z_abs_diff": float((replayed.z - eager.z).abs().max()),
        "z_scale": float(eager.z.abs().max()),
        "z_bitwise": all(bool(torch.equal(st.z, eager.z)) for st in (first, second, replayed)),
        "losses_equal": replayed.losses.tolist() == eager.losses.tolist(),
        "sync_debug_replay_bitwise": bool(torch.equal(z_debug, replayed.z)),
        "losses": replayed.losses.tolist(), "step_solver": replayed.step_solver,
        "graphs": sorted(loop.rec.graphs), "graph_pool_bytes": graph_pool_bytes(loop.rec.pool),
    }


def gn_graphs(tpt, dev, mesh_full=True):
    """Phase ``gn_graphs``: the Gauss-Newton loop recorded as CUDA graphs
    and replayed, against the same steps run eagerly on the card
    (:func:`gn_graph_case`), on the canonical solve (``'structured'``, 4
    steps), its ``'direct'`` step, phase 4's 16,200-row problem
    (``'structured'``: the peak memory with its pool), the Darcy inverse workload
    (``'structured'``, 8 steps), the Krylov fixtures of ``krylov_steps``
    in f64 (elliptic ``'cg'``, 4 steps; Darcy ``'woodbury'`` at nugget
    1e-3, 2 steps), and ``mesh_solve``'s
    42,500-row problem on the mesh path (``'cg'``; ``mesh_full=False``: a
    2,000 + 400 cut). The dense replays must equal the eager runs bitwise;
    the mesh replay within 1e-5 of z's scale (its CG exit may land one
    iteration apart on a tie)."""
    import torch

    from nonlinpdes_gpsolver_tpu_torch.solvers.distributed import gn_solve_distributed

    out = {}

    def dense(name, fp, steps, **kw):
        z0 = fp.problem.init_latent()
        row = gn_graph_case(tpt, fp, lambda f: tpt.gn_solve(f, z0=z0, max_iter=steps, **kw),
                            z0, steps)
        check(row["z_bitwise"] and row["losses_equal"] and row["sync_debug_replay_bitwise"],
              f"gn_graphs {name}: the replay differs from the eager steps "
              f"({row['z_abs_diff']:.3e})")
        out[name] = row

    inp = tpt.interop.load_canonical_inputs()
    prob = tpt.interop.problem_from_numpy(**inp, device=dev)
    fp = tpt.factorize(prob, 1e-5)
    dense("canonical_structured", fp, 4)
    dense("canonical_direct", fp, 4, step_solver="direct")
    for key, solver in out.items():
        check(solver["replayed"]["host_reads"] == 0,
              f"gn_graphs {key}: {solver['replayed']['host_reads']} host reads")
    del fp
    big = large_problem(tpt, dev)
    torch.cuda.reset_peak_memory_stats()
    fp = tpt.factorize(big, 1e-5)
    dense("large_structured", fp, 4)
    out["large_structured"]["max_memory_allocated"] = torch.cuda.max_memory_allocated()
    del fp, big
    torch.cuda.empty_cache()
    w = tpt.workloads.darcy(device=dev)
    dense("darcy_structured", tpt.factorize(w.problem, w.nugget), w.max_iter)
    check(out["darcy_structured"]["replayed"]["host_reads"] == 0, "gn_graphs darcy: host reads")
    gen = torch.Generator(device=dev).manual_seed(0)

    def u(x):
        return torch.sin(torch.pi * x[0]) * torch.sin(torch.pi * x[1])

    def rhs(x):
        return -torch.trace(torch.func.hessian(u)(x)) + u(x) ** 3

    Xd, Xb = tpt.utils.sample_random(gen, 120, 32, dtype=torch.float64)
    k = tpt.SquaredExponential.gaussian(0.3)
    fp = tpt.factorize(tpt.models.nonlinear_elliptic(k, Xd, Xb, rhs, u, seed=2), 1e-10)
    dense("krylov_elliptic_cg_f64", fp, 4, step_solver="cg", cg_tol=1e-14)
    gen = torch.Generator(device=dev).manual_seed(0)
    Xd, Xb = tpt.utils.sample_random(gen, 48, 16, dtype=torch.float64)
    k = tpt.SquaredExponential.gaussian(0.4)
    obs = torch.linspace(0.0, 0.01, 12, dtype=torch.float64, device=dev)
    prob = tpt.models.darcy_flow(k, k, Xd, Xb, obs, lambda x: torch.ones_like(x[0]),
                                 noise_level=1e-2, seed=3)
    fp = tpt.factorize(prob, 1e-3, solve_mode="trsm")  # 1e-3: a third of 1e-4's CG iterations
    dense("krylov_darcy_woodbury_f64", fp, 2, step_solver="woodbury", cg_tol=1e-9,
          cg_maxiter=2000)
    for key in ("krylov_elliptic_cg_f64", "krylov_darcy_woodbury_f64"):
        row = out[key]["replayed"]
        check(row["host_reads"] <= sum(row["cg_iters"]) + len(row["cg_iters"]) + 1,
              f"gn_graphs {key}: {row['host_reads']} host reads for {sum(row['cg_iters'])} "
              "CG iterations")
    del fp, w
    torch.cuda.empty_cache()
    sizes = {} if mesh_full else {"n_domain": 2000, "n_boundary": 400}
    w = tpt.workloads.mesh_elliptic(device=dev, **sizes)
    from nonlinpdes_gpsolver_tpu_torch.parallel import make_mesh

    mesh = make_mesh(1, device=dev)
    dfp = tpt.solvers.factorize_distributed(w.problem, mesh, nugget=w.nugget, block=512)
    z0 = w.problem.init_latent()
    row = gn_graph_case(tpt, dfp, lambda f: gn_solve_distributed(f, z0=z0, max_iter=w.max_iter),
                        z0, w.max_iter, mesh=True)
    for key in ("eager", "replayed"):
        r = row[key]
        r["ms_per_cg_iter"] = r["seconds"] / max(sum(r["cg_iters"]), 1) * 1e3
    row["z_rel_diff"] = row["z_abs_diff"] / row["z_scale"]
    check(row["z_rel_diff"] <= 1e-5 and row["sync_debug_replay_bitwise"],
          f"gn_graphs mesh: the replay differs from the eager steps ({row['z_rel_diff']:.3e})")
    row["gram_rows"] = dfp.factors["u"].n
    out["mesh_elliptic_cg"] = row
    del dfp, w
    torch.cuda.empty_cache()
    return out


def reuse_workloads(tpt, dev, names, large_sizes=(7800, 600), mesh_sizes=(20000, 2500)):
    """``make(k)`` of each case of ``structure_reuse``: the workload of its
    ``k``-th new problem, built anew from one configuration. ``canonical``:
    the JAX package's draw, then fresh draws of the port's sampler at the
    same N (seeds 1, 2, ...); Burgers, Eikonal and Darcy: their own draw;
    ``large``: phase 4's 16,200 rows and ``mesh``: ``mesh_solve``'s 42,500
    rows, each on its phase's draw, then on fresh draws of the sampler
    (``*_sizes``: cut, for a rehearsal on the CPU)."""
    import torch

    W = tpt.workloads
    Xt = tpt.utils.test_grid(60, 60, device=dev)
    truth = torch.func.vmap(W.u_elliptic)(Xt)

    def elliptic(Xd, Xb, seed):
        problem = tpt.models.nonlinear_elliptic(tpt.SquaredExponential.gaussian(0.2), Xd, Xb,
                                                W.elliptic_rhs(), W.u_elliptic, seed=seed)
        return W.Workload("elliptic", problem, Xt, truth, 1e-5, 4, {"test_l2": GATE_L2})

    def canonical(k):
        if k == 0:
            return W.elliptic(device=dev)
        return elliptic(*tpt.utils.sample_random(torch.Generator(device=dev).manual_seed(k),
                                                 900, 124), seed=k)

    makers = {
        "canonical": canonical,
        "burgers": lambda k: W.burgers(device=dev),
        "eikonal": lambda k: W.eikonal(device=dev),
        "darcy": lambda k: W.darcy(device=dev),
        "large": lambda k: W.Workload("elliptic_16200", large_problem(tpt, dev, large_sizes, k),
                                      Xt, truth, 1e-5, 4, {"test_l2": GATE_L2}),
        "mesh": lambda k: W.mesh_elliptic(device=dev, n_domain=mesh_sizes[0],
                                          n_boundary=mesh_sizes[1], seed=1 + k),
    }
    return {name: makers[name] for name in names}


REUSE_LAUNCHES = {"canonical": 2, "burgers": 2, "eikonal": 2, "darcy": 4, "large": 2}
HELD = ("canonical", "darcy", "large", "mesh")
# problems a sweep keeps alive, by case: the 42,500-row mesh case four (about 7.4 GB
# of factor each, and the guest entry's as much)
SWEEP = {"canonical": 6, "darcy": 6, "large": 6, "mesh": 4}


def bound_as():
    """How the factorizations since the last ``graphs.reset_counts()``
    bound (``solvers/_reuse.py``): ``made`` a new entry, ``rebound`` a
    released one's storage, ``unshared`` (no layout key), ``guest`` (a
    guest of its layout's guest entry)."""
    from nonlinpdes_gpsolver_tpu_torch.ops import graphs

    return (["made"] * graphs.ENTRIES + ["rebound"] * graphs.REBINDS
            + ["unshared"] * graphs.UNSHARED + ["guest"] * graphs.GUESTS)


class TwoPassSolver:
    """``GPSolver``'s mesh path at P = 1 with the two-pass factorization
    (``factorize_distributed(fused=False)``, which no facade takes): it
    factors when made, and ``solve(max_iter)`` runs the Gauss-Newton loop
    and the posterior weights, timed as ``GPSolver`` times its phases."""

    def __init__(self, tpt, problem, nugget, mesh, block=512):
        self.tpt, self.device = tpt, problem.device
        self.trace = tpt.utils.tracing.Record.continuing(problem.trace)
        with self.trace.solving(), self.trace.phase("factorize", self.device):
            self.fp = tpt.solvers.factorize_distributed(problem, mesh, nugget=nugget, block=block,
                                                        fused=False)

    def solve(self, max_iter):
        D = self.tpt.solvers.distributed
        with self.trace.solving():
            with self.trace.phase("gauss_newton", self.device):
                state = D.gn_solve_distributed(self.fp, max_iter=max_iter)
            with self.trace.phase("posterior_weights", self.device):
                post = D.DistributedPosterior(self.fp, state.z)
        return self.tpt.api.SolveResult(state=state, posterior=post, timers=self.trace.timers(),
                                        trace=self.trace)


def structure_reuse(tpt, dev, names=("canonical", "burgers", "eikonal", "darcy", "large", "mesh"),
                    runs=5, held=HELD, held_runs=6, two_pass_runs=3, sweep=None, **sizes):
    """Phase ``structure_reuse``, new problems of one structure as users'
    loops over them run. For each case of :func:`reuse_workloads`:

    * ``runs`` solves, each on a new problem and a new ``GPSolver``, the
      last one and its results gone first. The second rebinds the first
      one's storage and records its loop, later ones replay it with no
      capture; each run bitwise the same solver's eager solve;
    * for the cases in ``held``, ``held_runs`` solves with each run's
      solver and result kept until the next run's solve returns (``res =
      GPSolver(p).solve()``): the first two make entries, later ones
      rebind the entry released two runs back; from the fifth on nothing
      is recorded (each entry eager at its first use, recorded at its
      second);
    * for the cases in ``sweep`` (a dict, :data:`SWEEP` in the phase),
      ``sweep[name]`` solves with every
      solver and result kept to the end (a sweep): the first two make
      entries and every later problem is a guest of the layout's guest
      entry, its factors copied in once (``GUEST_LOADS``); an exact loop
      records at the guest entry's second use (the fourth solve) and
      replays from the fifth, a Krylov loop (the mesh case) records at
      its first and replays from the fourth; the live entries and graph
      pools are counted after each solve (three of each at most), and
      once the results are gone the released entries' bytes;

    and ``two_pass``: ``two_pass_runs`` solves of the ``large`` case on the
    mesh path's two-pass factorization (:class:`TwoPassSolver`), each
    solver gone before the next. Per run: e2e and GN seconds, captures,
    replays, host reads, K1 (and K2) launches, how the factorization bound
    (:func:`bound_as`), the peak memory, allocated and reserved (a
    retained graph pool shows in the latter only), and once the run's
    solver is gone the bytes the released entries keep
    (``RETAINED_BYTES``: storage and graph pool) and the guest loads. Every run must pass its
    gates and equal bitwise, in z and losses, a solve of the same problem
    that shares nothing with any entry (``_reuse._unshared``, recording
    off: its own factor, data and loop state, none of its tensors an
    entry's storage), which a bind that left stale storage or state would
    fail."""
    import torch

    from nonlinpdes_gpsolver_tpu_torch.ops import graphs
    from nonlinpdes_gpsolver_tpu_torch.solvers import _reuse

    cuda = torch.device(dev).type == "cuda"
    sweep = sweep or {}
    makers = reuse_workloads(tpt, dev, set(names) | set(held) | set(sweep) | {"large"}, **sizes)

    def new_solver(w, two_pass=False):
        mesh = tpt.parallel.make_mesh(1, device=dev) if w.mesh or two_pass else None
        if two_pass:
            return TwoPassSolver(tpt, w.problem, w.nugget, mesh)
        return tpt.GPSolver(w.problem, nugget=w.nugget, mesh=mesh)

    def stored(fp):
        D = tpt.solvers.distributed
        by_block = (D.mesh_tensors(fp) if isinstance(fp, D.DistributedFactoredProblem)
                    else tpt.solvers.gn.dense_tensors(fp))
        return [t for roles in by_block.values() for t in roles.values()]

    def run(name, k, w, two_pass=False, eager=True):
        """One solve of ``w`` on a new solver: ``(row, solver, result)``."""
        if cuda:
            torch.cuda.reset_peak_memory_stats()
        zero_counts()
        graphs.reset_counts()
        t0 = time.perf_counter()
        solver = new_solver(w, two_pass)
        res = solver.solve(max_iter=w.max_iter)
        metrics = w.metrics(res)
        sync(dev)
        e2e = time.perf_counter() - t0
        launches = counts()
        row = {"e2e_seconds": e2e, "gn_seconds": res.timers["gauss_newton"],
               "phase_seconds": res.timers, "captures": graphs.CAPTURES,
               "replays": graphs.REPLAYS, "host_reads": graphs.HOST_READS,
               "k1_launches": launches[0], "k2_launches": launches[1],
               "trsm_launches": launches[2], "bind": bound_as(),
               "guest_loads": graphs.GUEST_LOADS,
               "max_memory_allocated": torch.cuda.max_memory_allocated() if cuda else None,
               "max_memory_reserved": torch.cuda.max_memory_reserved() if cuda else None,
               "metrics": metrics,
               "losses": res.state.losses.tolist(), "cg_iters": res.state.cg_iters.tolist(),
               "rungs": res.posterior.fp.rungs, "step_solver": res.state.step_solver}
        with graphs.uncaptured():
            if eager:
                again = solver.solve(max_iter=w.max_iter)
                row["bitwise_eager"] = (bool(torch.equal(res.z, again.z)) and
                                        bool(torch.equal(res.state.losses, again.state.losses)))
                del again
            with _reuse._unshared():
                alone = new_solver(w, two_pass)
            row["reference_unshared"] = not any(_reuse._in_entry(t) for t in stored(alone.fp))
            ref = alone.solve(max_iter=w.max_iter)
        row["bitwise_unshared"] = (bool(torch.equal(res.z, ref.z))
                                   and bool(torch.equal(res.state.losses, ref.state.losses)))
        del alone, ref
        if cuda:  # the reference's freed blocks would show in the next run's reserved peak
            torch.cuda.empty_cache()
        failed = w.failures(metrics)
        tag = f"structure_reuse {name} run {k + 1}"
        check(not failed, f"{tag}: " + "; ".join(failed))
        check(bool(res.state.converged_finite), f"{tag}: a GN step was rejected")
        check(not eager or row["bitwise_eager"], f"{tag}: z or losses differ from the eager solve")
        check(row["reference_unshared"] and row["bitwise_unshared"],
              f"{tag}: z or losses differ from an unshared solve of the problem")
        expected = None if two_pass else REUSE_LAUNCHES.get(name.split(" ")[0])
        check(not cuda or (launches[0] == expected if expected else min(launches) > 0),
              f"{tag}: K1 and K2 launched {launches} times")
        return row, solver, res

    out = {}
    tpt.clear_graph_cache()  # each case's first problem makes its entry
    for name in names:
        rows = []
        for k in range(runs):
            t0 = time.perf_counter()
            w = makers[name](k)
            sync(dev)
            build_s = time.perf_counter() - t0
            row, solver, res = run(name, k, w)
            row["build_seconds"] = build_s
            tag = f"structure_reuse {name} run {k + 1}"
            check(k == 0 or row["bind"] == ["rebound"], f"{tag}: bound as {row['bind']}")
            check(k < 2 or row["captures"] == 0, f"{tag}: {row['captures']} captures")
            del w, solver, res
            row["retained_bytes"] = graphs.RETAINED_BYTES  # the run's entry, released
            rows.append(row)
        out[name] = rows
    rows = []
    tpt.clear_graph_cache()  # cut to CPU sizes, the mesh case can have its layout
    for k in range(two_pass_runs):
        row, solver, res = run("two_pass", k, makers["large"](k), two_pass=True)
        tag = f"structure_reuse two_pass run {k + 1}"
        check(row["bind"] == (["made"] if k == 0 else ["rebound"]), f"{tag}: bound as {row['bind']}")
        check(k < 1 or row["captures"] == 0, f"{tag}: {row['captures']} captures")
        del solver, res
        row["retained_bytes"] = graphs.RETAINED_BYTES
        rows.append(row)
    out["two_pass"] = rows
    out["held"] = {}
    for name in held:
        tpt.clear_graph_cache()
        rows, last = [], None
        for k in range(held_runs):
            w = makers[name](k)
            sync(dev)
            row, solver, res = run(f"{name} held", k, w, eager=False)
            last = None  # the last run's solver and result, kept until this solve returned
            row["retained_bytes"] = graphs.RETAINED_BYTES  # its entry, released
            tag = f"structure_reuse {name} held run {k + 1}"
            check(row["bind"] == (["made"] if k < 2 else ["rebound"]),
                  f"{tag}: bound as {row['bind']}")
            check(k < 4 or row["captures"] == 0, f"{tag}: {row['captures']} captures")
            last = (solver, res)  # noqa: F841
            del w, solver, res
            rows.append(row)
        del last
        out["held"][name] = rows
    if sweep:
        out["sweep"] = {name: sweep_case(tpt, dev, name, n, makers[name], run)
                        for name, n in sweep.items()}
    tpt.clear_graph_cache()
    if cuda:
        torch.cuda.empty_cache()
    return out


def sweep_case(tpt, dev, name, n, make, run):
    """``n`` solves of ``structure_reuse``'s case ``name`` (``make(k)``,
    ``run`` as there) with every solver and result kept to the end. Around
    each solve: the live entries before it, then the bind (``made`` twice,
    then ``guest``), one guest load a guest, the captures (none from the
    fifth solve of an exact loop, the fourth of a Krylov one, which
    replay), at most three live entries and graph pools, and z and losses
    bitwise an unshared solve (``run``). Then, the results gone, the
    released entries and their bytes."""
    import torch

    from nonlinpdes_gpsolver_tpu_torch.ops import graphs
    from nonlinpdes_gpsolver_tpu_torch.solvers import _reuse

    cuda = torch.device(dev).type == "cuda"
    tpt.clear_graph_cache()
    if cuda:
        torch.cuda.empty_cache()
    rows, alive = [], []
    for k in range(n):
        tag = f"structure_reuse {name} sweep run {k + 1}"
        check(len(_reuse.entries()) == min(k, 2) + (k >= 3), f"{tag}: "
              f"{len(_reuse.entries())} entries before the solve")
        w = make(k)
        sync(dev)
        row, solver, res = run(f"{name} sweep", k, w, eager=False)
        krylov = row["step_solver"] in ("cg", "woodbury")
        pools = {tuple(e.pool) for e in _reuse.entries() if e.pool is not None}
        row.update(entries=len(_reuse.entries()), graph_pools=len(pools),
                   graph_pool_bytes=sum(_reuse._pool_bytes(pools).values()) if cuda else 0,
                   memory_allocated=torch.cuda.memory_allocated() if cuda else None,
                   memory_reserved=torch.cuda.memory_reserved() if cuda else None)
        check(row["bind"] == (["made"] if k < 2 else ["guest"]), f"{tag}: bound as {row['bind']}")
        check(row["guest_loads"] == (k >= 2), f"{tag}: {row['guest_loads']} guest loads")
        check(row["entries"] == min(k + 1, 2) + (k >= 2) and row["graph_pools"] <= 3,
              f"{tag}: {row['entries']} entries, {row['graph_pools']} graph pools")
        if cuda and k >= (3 if krylov else 4):
            check(row["captures"] == 0 and row["replays"] > 0,
                  f"{tag}: recorded {row['captures']}, replayed {row['replays']} graphs")
        host = _reuse.serving(solver.fp)
        check((k >= 2) == (host is not None and host.hosting and _reuse.bound_entry(solver.fp)
                           is None), f"{tag}: served by {host}")
        rows.append(row)
        alive.append((solver, res))
        del w, solver, res
    del alive
    released = [e for e in _reuse.entries() if e.released]
    out = {"runs": rows, "released_entries": len(released),
           "retained_bytes": graphs.RETAINED_BYTES,
           "retained_entry_bytes": sum(e.nbytes for e in released)}
    check(len(_reuse.entries()) == len(released) == 1,
          f"structure_reuse {name} sweep: {len(_reuse.entries())} entries once the results "
          f"are gone, {len(released)} released")
    return out


LIMITS = {"float32": 1e-5, "float64": 1e-12}  # of a block's scale, kernel against plain


def sync(dev=None):
    import torch

    if dev is None or torch.device(dev).type == "cuda":
        torch.cuda.synchronize()


def counts():
    """Launches since :func:`zero_counts`: K1, K2 and the row-block
    triangular-solve kernel."""
    from nonlinpdes_gpsolver_tpu_torch.ops import gram_tile, trsm_rowblock

    return gram_tile.LAUNCHES, gram_tile.K2_LAUNCHES, trsm_rowblock.LAUNCHES


def zero_counts():
    from nonlinpdes_gpsolver_tpu_torch.ops import gram_tile, trsm_rowblock

    gram_tile.LAUNCHES = gram_tile.K2_LAUNCHES = trsm_rowblock.LAUNCHES = 0


def check_k2(what, plan, sets, d_r, d_c):
    """One K2 launch of ``plan`` into a slot of a larger buffer against its
    plain version on the same inputs: each block within the dtype's limit
    of its scale, fill blocks and the diagonal exact, nothing written
    outside the slot."""
    import torch

    dtype = str(sets[0].dtype).split(".")[1]
    h, S = plan.shape
    big = torch.full((h + 8, S + 16), 7.0, dtype=sets[0].dtype, device=sets[0].device)
    slot = big[4 : 4 + h, 8 : 8 + S]
    before = counts()
    plan.run_equilibrated(sets, d_r, d_c, out=slot)
    sync()
    after = counts()
    check(after[:2] == (before[0], before[1] + 1), f"K2 {what}: launches {before} -> {after}")
    ref = torch.empty((h, S), dtype=sets[0].dtype, device=sets[0].device)
    plan._plain_equilibrated(sets, d_r, d_c, ref)
    rel, diff = blockwise_rel_err(plan, slot, ref)
    check(math.isfinite(rel) and rel <= LIMITS[dtype], f"K2 {what} {dtype}: {rel:.3e}")
    w = plan.window_rows(slot.device)  # the rows' window rows: the unit diagonal's columns
    on = w < S
    check(bool((slot[torch.nonzero(on)[:, 0], w[on]] == 1.0).all()),
          f"K2 {what} {dtype}: diagonal not exactly 1")
    for b in plan.blocks:
        if b.fill:
            rs, cs = slice(b.row_off, b.row_off + b.n), slice(b.col_off, b.col_off + b.m)
            check(bool(torch.equal(slot[rs, cs], ref[rs, cs])), f"K2 {what}: fill block differs")
    slot.fill_(7.0)
    check(bool((big == 7.0).all()), f"K2 {what} {dtype}: wrote outside its slot")
    return {"what": what, "shape": [h, S], "dtype": dtype, "blocks": len(plan.blocks),
            "fill_blocks": sum(b.fill for b in plan.blocks), "sets": len(plan.set_sizes),
            "row_map": plan.row_map, "rel_err": rel, "max_abs_err": diff}


def window_cases(block, points, nugget, dtype=None, rows=512, S=2048, ranks=1, rank=0):
    """``(name, plan, sets, d_r, d_c)`` of every K2 launch of the fused
    factorization of GP ``block`` (``rows``-row blocks, ``S``-wide
    superblocks) on rank ``rank`` of ``ranks`` (rank-mapped plans past one
    rank; a window where the rank owns no row has no launch), at the
    nugget's equilibration, optionally cast."""
    import torch

    from nonlinpdes_gpsolver_tpu_torch.ops.assembly import observable_sizes
    from nonlinpdes_gpsolver_tpu_torch.parallel import fused, gram, pad_to_blocks

    pts = points if dtype is None else {k: v.to(dtype) for k, v in points.items()}
    obs = block.observables
    sizes = observable_sizes(obs, pts)
    n = sum(sizes)
    n_pad = pad_to_blocks(n, rows, ranks)
    ref = pts[obs[0].points]
    c, nug = gram._equilibration_parts(block.kernel, gram._segments(obs, pts), "adaptive",
                                       nugget, ref.dtype, ref.device)
    d_pad = torch.cat([torch.rsqrt(c + nug), c.new_ones(n_pad - n)])
    out = []
    for kb0, F in fused._superblocks(n_pad // rows, S // rows):
        c0, c1 = kb0 * rows, (kb0 + F) * rows
        plan = fused.window_plan(block.kernel, obs, sizes, c0, c1, n_pad, ranks, rank, rows)
        if plan.shape[0] == 0:
            continue
        tag = f" rank {rank} of {ranks}" if ranks > 1 else ""
        out.append((f"window [{c0}, {c1}) of {n_pad}{tag}", plan, gram.window_sets(plan, pts),
                    d_pad[c0:], d_pad[c0:c1]))
    return out


def time_k2(cases, reps, plain_reps):
    """Each K2 launch held against its plain version (:func:`check_k2`),
    then its device ms, plain ms, host us per launch and bound; and the
    sums, with the largest error."""
    import torch

    rows = []
    for name, plan, sets, d_r, d_c in cases:
        checked = check_k2(name, plan, sets, d_r, d_c)
        buf = torch.empty(plan.shape, dtype=sets[0].dtype, device=sets[0].device)
        bound, by = k1_bound_ms(plan, checked["dtype"])
        ms = time_ms(lambda: plan.run_equilibrated(sets, d_r, d_c, out=buf), reps)
        rows.append({**checked, "ms": ms, "plain_ms": time_ms(lambda: plan._plain_equilibrated(
                         sets, d_r, d_c, buf), plain_reps),
                     "host_us_per_call": host_us(lambda: plan.run_equilibrated(
                         sets, d_r, d_c, out=buf), reps),
                     "bound_ms": bound, "bound_by": by, "share_of_bound": bound / ms})
        del buf
    total = {k: sum(r[k] for r in rows) for k in ("ms", "plain_ms", "bound_ms")}
    total["max_abs_err"] = max(r["max_abs_err"] for r in rows)
    total["share_of_bound"] = total["bound_ms"] / total["ms"]
    shares = [r["share_of_bound"] for r in rows]
    total["window_share_min_max"] = [min(shares), max(shares)]
    return rows, total


def k2_vs_plain(tpt, dev):
    """K2 against its plain version on the card: every superblock window of
    a 5,000-row elliptic layout (N 2,300, 400 boundary points; 512-row
    blocks, S = 2,048: three windows, the last a ragged 1,024 wide with the
    padding), a window of the Darcy u layout at N_d = 3,000 that straddles
    two segments, and the whole Darcy u layout at N_d = 300 (one window, 25
    blocks and 2 fill blocks), in f32 and f64 (limits 1e-5 and 1e-12 of a
    block's scale), each one launch with an exact unit diagonal and nothing
    written outside its slot; then each timed in f32. Then K2 on a rank's
    block-cyclic rows (rank-mapped plans): the elliptic layout's windows on
    ranks 0 and 1 of 2 (the same three windows, 5,120 padded rows) and on
    rank 3 of 4 (6,144 padded rows: its last block lies in the padding), the
    same checks, and the P = 2 windows timed in f32 beside the unmapped ones."""
    import torch

    gen = torch.Generator(device=dev).manual_seed(0)
    k = tpt.SquaredExponential.gaussian(0.2)
    Xd, Xb = tpt.utils.sample_random(gen, 2300, 400)
    ell = tpt.models.nonlinear_elliptic(k, Xd, Xb, None, None)
    layouts = [("elliptic 5,000", ell, lambda c: c)]
    for n_d in (3000, 300):
        Xd, Xb = tpt.utils.sample_random(gen, n_d, n_d // 4)
        darcy = tpt.models.darcy_flow(k, k, Xd, Xb, torch.zeros(60, device=dev), None)
        pick = (lambda c: c[1:2]) if n_d == 3000 else (lambda c: c)
        layouts.append((f"darcy u N_d={n_d}", darcy, pick))
    cases = {dtype: [(f"{name} {what}", *case) for name, prob, pick in layouts
                     for what, *case in pick(window_cases(prob.block("u"), prob.points, 1e-5, dtype))]
             for dtype in (torch.float32, torch.float64)}
    times, total = time_k2(cases[torch.float32], 20, 3)
    rows = times + [check_k2(*case) for case in cases[torch.float64]]
    mapped = {dtype: [(f"elliptic 5,000 {what}", *case) for P, p in ((2, 0), (2, 1), (4, 3))
                      for what, *case in window_cases(ell.block("u"), ell.points, 1e-5, dtype,
                                                      ranks=P, rank=p)]
              for dtype in (torch.float32, torch.float64)}
    f32 = mapped[torch.float32]
    mtimes, mtotal = time_k2([c for c in f32 if " of 2" in c[0]], 20, 3)
    mrows = mtimes + [check_k2(*c) for c in f32 if " of 2" not in c[0]]
    mrows += [check_k2(*case) for case in mapped[torch.float64]]
    return {"cases": rows, "total": total, "rank_mapped_cases": mrows,
            "rank_mapped_total": mtotal,
            "worst_rel_err": {d: max(r["rel_err"] for r in rows + mrows if r["dtype"] == d)
                              for d in LIMITS}}


def mesh_k1_cases(tpt, problem, X_test, extended=("u",)):
    """``(name, plan, sets)`` of the K1 launches of a mesh-path solve: each
    block's sampled-row probe (one cross-Gram a segment, 32 rows) and each
    extended block's test cross-Gram chunks."""
    import numpy as np
    import torch

    from nonlinpdes_gpsolver_tpu_torch.ops import gram_tile
    from nonlinpdes_gpsolver_tpu_torch.ops.operators import identity
    from nonlinpdes_gpsolver_tpu_torch.solvers.posterior import _row_chunks, _serving_chunk

    pts, out = problem.points, []
    for blk in problem.blocks:
        obs = blk.observables
        sizes = tpt.ops.observable_sizes(obs, pts)
        for o, size in zip(obs, sizes):
            idx = torch.as_tensor(np.linspace(0, size - 1, min(32, size)).astype(int), device=X_test.device)
            plan = gram_tile.cross_plan(blk.kernel, o.op, int(idx.shape[0]), obs, sizes)
            out.append((f"probe {blk.name}", plan, [pts[o.points][idx], *(pts[k] for k in plan.set_keys)]))
        if blk.name in extended:
            for xs in _row_chunks(X_test, _serving_chunk(int(X_test.shape[0]), sum(sizes))):
                plan = gram_tile.cross_plan(blk.kernel, identity(), int(xs.shape[0]), obs, sizes)
                out.append((f"extension {blk.name}", plan, [xs.contiguous(), *(pts[k] for k in plan.set_keys)]))
    return out


def time_k1(cases, reps, plain_reps):
    """Device ms, plain ms and the bound of each K1 launch, and the sums."""
    import torch

    rows = []
    for name, plan, sets in cases:
        buf = torch.empty(plan.shape, dtype=sets[0].dtype, device=sets[0].device)
        bound, by = k1_bound_ms(plan, str(buf.dtype).split(".")[1])
        ms = time_ms(lambda: plan.run(sets, out=buf), reps)
        ref = torch.zeros_like(buf)
        plan._plain(sets, ref)
        plan.run(sets, out=buf)
        rel, diff = blockwise_rel_err(plan, buf, ref)
        check(rel <= LIMITS[str(buf.dtype).split(".")[1]], f"K1 {name}: {rel:.3e}")
        rows.append({"launch": name, "shape": list(plan.shape), "ms": ms,
                     "plain_ms": time_ms(lambda: plan._plain(sets, buf), plain_reps),
                     "bound_ms": bound, "bound_by": by, "rel_err": rel, "max_abs_err": diff})
        del buf, ref
    total = {k: sum(r[k] for r in rows) for k in ("ms", "plain_ms", "bound_ms")}
    total["max_abs_err"] = max(r["max_abs_err"] for r in rows)
    return rows, total


def mesh_run(w, auto=False, mesh=None):
    """One solve of workload ``w`` on the mesh path and its metrics, with
    the extension timed: ``GPSolver(problem, nugget)`` (``auto``: routed by
    auto_mesh) or ``w.solve(mesh)`` (an explicit mesh: the card alone, or
    ``mesh``); and how its factorization bound (:func:`bound_as`)."""
    import nonlinpdes_gpsolver_tpu_torch as tpt
    from nonlinpdes_gpsolver_tpu_torch.ops import graphs

    dev = w.problem.device
    graphs.reset_counts()
    t0 = time.perf_counter()
    res = (tpt.GPSolver(w.problem, nugget=w.nugget).solve(max_iter=w.max_iter) if auto
           else w.solve(mesh))
    sync(dev)
    t1 = time.perf_counter()
    metrics = w.metrics(res)
    sync(dev)
    t2 = time.perf_counter()
    return res, metrics, {"e2e_seconds": t2 - t0, "solve_seconds": t1 - t0,
                          "extension_seconds": t2 - t1, "phase_seconds": res.timers,
                          "bind": bound_as()}


def mesh_report(res, metrics, timing, launches, peak):
    fp = res.posterior.fp
    iters = res.state.cg_iters.tolist()
    gn = timing["phase_seconds"]["gauss_newton"]
    return {**timing, "metrics": metrics, "gram_rows": {b: f.n for b, f in fp.factors.items()},
            "n_pad": {b: f.n_pad for b, f in fp.factors.items()},
            "nugget_scales": fp.nugget_scales, "rungs": fp.rungs, "quality": fp.quality,
            "factor_stats": fp.stats, "losses": res.state.losses.tolist(), "cg_iters": iters,
            "gn_ms_per_cg_iter": gn / sum(iters) * 1e3 if sum(iters) else None,
            "converged_finite": bool(res.state.converged_finite),
            "k1_launches": launches[0], "k2_launches": launches[1],
            "trsm_launches": launches[2], "max_memory_allocated": peak}


def mesh_phase(w, repeats, auto=False, keep=None):
    """A cold solve of a mesh workload, a warm one (counted: K1 and K2
    launches, peak memory; and the device ms of one kernel solve, the two
    triangular solves of each CG operator application), then ``repeats``
    more; its gates checked. The step solver and deflation rank are the
    ones the solve recorded. ``keep`` receives the warm solve's ``z``."""
    import torch

    cold = mesh_run(w, auto)[2]
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    res, metrics, timing = mesh_run(w, auto)
    report = mesh_report(res, metrics, timing, counts(), torch.cuda.max_memory_allocated())
    fp = res.posterior.fp
    report["step_solver"] = res.state.step_solver
    report["deflation_rank"] = res.state.deflation_rank
    v = {b: torch.randn(f.n, device=f.local.device) for b, f in fp.factors.items()}
    report["kernel_solve_ms"] = {b: time_ms(lambda: fp.kernel_solve(b, v[b]), 10) for b in v}
    report["routed_to_mesh"] = type(res.posterior).__name__ == "DistributedPosterior"
    if keep is not None:
        keep["z"] = res.z.clone()
    del res, fp
    report["cold"] = cold
    report["repeats"] = [mesh_run(w, auto)[2] for _ in range(repeats)]
    failed = w.failures(metrics)
    check(not failed, "; ".join(failed))
    check(report["converged_finite"], f"{w.name}: a GN step had no finite trial")
    return report


# -- the mesh path across ranks ------------------------------------------------------
#
# Each phase spawns its ranks with torch.multiprocessing (spawn, not fork: the
# parent holds a CUDA context) and the torchrun variables (RANK, LOCAL_RANK,
# WORLD_SIZE, MASTER_ADDR, MASTER_PORT), so that each rank starts its group
# with parallel.initialize_distributed(backend=...), as a user's program under
# torchrun would. Every rank writes a JSON report into a temporary directory
# (rank 0 also its solution), and any rank's failure fails the phase.

FULL_SIZES = {"mesh_elliptic": (20000, 2500), "darcy_past_wall": 3000, "nccl": (7800, 600)}


def _rank_entry(rank, fn, world, port, args):
    os.environ.update(RANK=str(rank), LOCAL_RANK=str(rank), WORLD_SIZE=str(world),
                      MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
    import torch.distributed as dist

    try:
        fn(rank, world, *args)
    finally:
        if dist.is_initialized():
            from nonlinpdes_gpsolver_tpu_torch import clear_graph_cache

            # NCCL's teardown waits for every CUDA graph that recorded its
            # collectives: the recorded loops go first
            clear_graph_cache()
            gc.collect()
            dist.destroy_process_group()


def spawn_ranks(fn, world, *args):
    """``fn(rank, world, *args)`` on ``world`` spawned processes; returns when
    all have ended, and raises if any failed (the others are stopped)."""
    import torch.multiprocessing as mp

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    mp.spawn(_rank_entry, args=(fn, world, port, args), nprocs=world, join=True)


def _write(tmp, name, obj):
    with open(os.path.join(tmp, name), "w") as fh:
        json.dump(obj, fh)


def _read(tmp, name):
    with open(os.path.join(tmp, name)) as fh:
        return json.load(fh)


def mesh_ranks_rank(rank, world, tmp, device, sizes):
    """One rank of phase ``mesh_ranks``: ``world`` ranks over gloo, all on
    ``device`` (one card shared; the collectives go through host memory).

    1. its K2 windows of ``mesh_elliptic``'s fused factorization, each checked
       against its plain version and timed, one rank at a time;
    2. ``mesh_elliptic`` through ``w.solve(mesh)``, routed to ``'cg'``: a cold
       solve, then a counted warm one (K1 and K2 launches, peak memory);
    3. ``darcy_past_wall`` with ``'woodbury'``, one solve;
    4. ``mesh_steps``' five step solvers in f64 against the dense ``'direct'``.
    """
    import torch
    import torch.distributed as dist

    import nonlinpdes_gpsolver_tpu_torch as tpt
    from nonlinpdes_gpsolver_tpu_torch.parallel import initialize_distributed, make_mesh

    check(initialize_distributed(backend="gloo"), "the gloo group did not start")
    mesh = make_mesh(world, device=device)
    dev = mesh.device
    on_card = dev.type == "cuda"
    out = {"rank": rank, "ranks": mesh.size, "backend": mesh.backend, "device": str(dev)}
    n, nb = sizes["mesh_elliptic"]
    w = tpt.workloads.mesh_elliptic(device=dev, n_domain=n, n_boundary=nb)
    if on_card:
        for r in range(world):
            if r == rank:
                cases = window_cases(w.problem.blocks[0], w.problem.points, w.nugget,
                                     ranks=world, rank=rank)
                out["k2_windows"], out["k2_total"] = time_k2(cases, 5, 1)
            dist.barrier()
    cold = mesh_run(w, mesh=mesh)[2]
    if on_card:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    zero_counts()
    res, metrics, timing = mesh_run(w, mesh=mesh)
    peak = torch.cuda.max_memory_allocated() if on_card else None
    rep = mesh_report(res, metrics, timing, counts(), peak)
    rep.update(cold=cold, step_solver=res.state.step_solver, failures=w.failures(metrics),
               local_rows={b: int(f.local.shape[0] * f.block) for b, f in
                           res.posterior.fp.factors.items()})
    out["mesh_elliptic"] = rep
    if rank == 0:
        torch.save(res.z.cpu(), os.path.join(tmp, "z_mesh_elliptic.pt"))
    del res, w
    wd = tpt.workloads.darcy_past_wall(device=dev, n_domain=sizes["darcy_past_wall"])
    if on_card:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    zero_counts()
    res, metrics, timing = mesh_run(wd, mesh=mesh)
    peak = torch.cuda.max_memory_allocated() if on_card else None
    rep = mesh_report(res, metrics, timing, counts(), peak)
    rep.update(step_solver=res.state.step_solver, deflation_rank=res.state.deflation_rank,
               failures=wd.failures(metrics))
    out["darcy_past_wall"] = rep
    del res, wd
    t0 = time.perf_counter()
    out["mesh_steps"] = mesh_steps(tpt, dev, mesh, (torch.float64,))
    out["mesh_steps_seconds"] = time.perf_counter() - t0
    _write(tmp, f"rank{rank}.json", out)


def gn_replayed_and_eager(fp, steps):
    """The Gauss-Newton loop alone on the factored problem ``fp`` (its
    loop recorded already): replayed, then run eagerly
    (``graphs.uncaptured()``), each synchronized, with its seconds, ms a CG
    iteration, host reads, captures, replays, and collectives (eager,
    recorded) and host agreements; and whether the replay's z and losses
    are the eager run's bits. ``expected_host_reads`` is the P = 1 count:
    one a step and, for a Krylov step, each CG loop's lagged reads (its
    iterations and one more, at most ``cg_maxiter``) and on the card one
    for the CG counts."""
    import torch

    from nonlinpdes_gpsolver_tpu_torch.ops import graphs
    from nonlinpdes_gpsolver_tpu_torch.parallel import comm
    from nonlinpdes_gpsolver_tpu_torch.solvers.distributed import gn_solve_distributed

    dev = fp.problem.device
    out, states = {}, {}
    for name in ("replayed", "eager"):
        graphs.reset_counts()
        comm.reset_counts()
        sync(dev)
        t0 = time.perf_counter()
        if name == "eager":
            with graphs.uncaptured():
                st = gn_solve_distributed(fp, max_iter=steps)
        else:
            st = gn_solve_distributed(fp, max_iter=steps)
        sync(dev)
        secs = time.perf_counter() - t0
        iters = st.cg_iters.tolist()
        reads = steps  # the step codes; a Krylov step's CG reads, and the counts' copy
        if st.step_solver in ("cg", "woodbury"):
            reads += sum(min(k + 1, 500) for k in iters) + (dev.type == "cuda")
        out[name] = {"seconds": secs, "cg_iters": iters,
                     "ms_per_cg_iter": secs / max(sum(iters), 1) * 1e3,
                     "host_reads": graphs.HOST_READS, "captures": graphs.CAPTURES,
                     "replays": graphs.REPLAYS, "eager_collectives": comm.COLLECTIVES,
                     "recorded_collectives": comm.RECORDED,
                     "host_agreements": comm.AGREEMENTS,
                     "expected_host_reads": reads}
        states[name] = st
    rep, eag = states["replayed"], states["eager"]
    out["bitwise"] = bool(torch.equal(rep.z, eag.z) and torch.equal(rep.losses, eag.losses))
    return out, rep


def mesh_nccl_rank(rank, world, tmp, backend, sizes, device=None):
    """One rank of phase ``mesh_nccl``: one rank per card over ``backend``
    (NCCL on the card), the 16,200-row elliptic problem of phase 4 on the
    mesh path. Cold: a new entry, its Gauss-Newton loop recorded with its
    collectives inside (``'cg'`` records in its first call). Warm: a new
    solver of the same problem rebinds the cold one's entry and replays,
    with its L2, seconds and solution. Then on the warm solver's factors
    the loop alone, replayed and eagerly (:func:`gn_replayed_and_eager`).
    Then, the warm result gone, a second problem of the layout (the
    sampler's seed 1), which must rebind with no capture, beside the same
    problem solved unshared (``_reuse._unshared()``). Then a sweep: two
    results kept (seeds 2 and 3), and a third live problem (seed 4), a
    guest on every rank, its loop recorded on the guest entry with its
    collectives and replayed, beside its unshared solve. Last the exact
    step recorded (:func:`exact_step_recorded`)."""
    import torch

    import nonlinpdes_gpsolver_tpu_torch as tpt
    from nonlinpdes_gpsolver_tpu_torch.ops import graphs
    from nonlinpdes_gpsolver_tpu_torch.parallel import comm, initialize_distributed, make_mesh
    from nonlinpdes_gpsolver_tpu_torch.solvers import _reuse

    check(initialize_distributed(backend=backend), f"the {backend} group did not start")
    mesh = make_mesh(world, device=device)
    dev = mesh.device
    on_card = dev.type == "cuda"
    n, nb = sizes["nccl"]
    steps = 4

    def problem(seed):
        return large_problem(tpt, dev, (n, nb), seed=seed)

    prob = problem(0)
    Xt = tpt.utils.test_grid(60, 60, device=dev)
    truth = torch.func.vmap(tpt.workloads.u_elliptic)(Xt)

    def run(p):
        t0 = time.perf_counter()
        res = tpt.GPSolver(p, nugget=1e-5, mesh=mesh).solve(max_iter=steps)
        err = tpt.GPSolver.errors(res.posterior.extend(Xt), truth)
        sync(dev)
        return res, err, time.perf_counter() - t0

    graphs.reset_counts()
    comm.reset_counts()
    cold = run(prob)[2]
    cold_counts = {"captures": graphs.CAPTURES, "recorded_collectives": comm.RECORDED,
                   "entries": graphs.ENTRIES}
    if on_card:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    zero_counts()
    graphs.reset_counts()
    comm.reset_counts()
    res, err, secs = run(prob)
    k1, k2, trsm = counts()
    out = {"rank": rank, "ranks": mesh.size, "backend": mesh.backend, "device": str(dev),
           "collectives": comm.COLLECTIVES, "cold": cold_counts,
           "warm": {"captures": graphs.CAPTURES, "replays": graphs.REPLAYS,
                    "rebinds": graphs.REBINDS, "host_reads": graphs.HOST_READS},
           "group_of_one": mesh.size == 1, "gram_rows": 2 * n + nb, "cold_seconds": cold,
           "e2e_seconds": secs, "phase_seconds": res.timers, "test_l2": err.l2,
           "max_memory_allocated": torch.cuda.max_memory_allocated() if on_card else None,
           "rungs": res.posterior.fp.rungs, "cg_iters": res.state.cg_iters.tolist(),
           "step_solver": res.state.step_solver, "k1_launches": k1, "k2_launches": k2,
           "trsm_launches": trsm, "converged_finite": bool(res.state.converged_finite)}
    if rank == 0:
        torch.save(res.z.cpu(), os.path.join(tmp, "z_nccl.pt"))
    out["gn"], st = gn_replayed_and_eager(res.posterior.fp, steps)
    out["gn"]["solve_bitwise"] = bool(torch.equal(st.z, res.z))
    del res, st
    graphs.reset_counts()
    res, err, secs = run(problem(1))
    z2 = res.z.clone()
    out["second"] = {"rebinds": graphs.REBINDS, "entries": graphs.ENTRIES,
                     "captures": graphs.CAPTURES, "replays": graphs.REPLAYS,
                     "e2e_seconds": secs, "test_l2": err.l2, "cg_iters": res.state.cg_iters.tolist()}
    del res
    with _reuse._unshared():
        res, _, _ = run(problem(1))
    out["second"]["unshared_bitwise"] = bool(torch.equal(res.z, z2))
    del res
    # a sweep on the group: two results kept, then a third live problem, a guest
    kept = [run(problem(seed))[0] for seed in (2, 3)]
    graphs.reset_counts()
    comm.reset_counts()
    res, err, secs = run(problem(4))
    zg = res.z.clone()
    out["guest"] = {"guests": graphs.GUESTS, "guest_loads": graphs.GUEST_LOADS,
                    "entries": graphs.ENTRIES, "rebinds": graphs.REBINDS,
                    "captures": graphs.CAPTURES, "replays": graphs.REPLAYS,
                    "recorded_collectives": comm.RECORDED, "host_agreements": comm.AGREEMENTS,
                    "e2e_seconds": secs, "test_l2": err.l2, "cg_iters": res.state.cg_iters.tolist(),
                    "bound": _reuse.bound_entry(res.posterior.fp) is not None,
                    "live_entries": len(_reuse.entries())}
    del res, kept
    with _reuse._unshared():
        res, _, _ = run(problem(4))
    out["guest"]["unshared_bitwise"] = bool(torch.equal(res.z, zg))
    del res
    out["exact"] = exact_step_recorded(tpt, mesh)
    _write(tmp, f"rank{rank}.json", out)


def exact_step_recorded(tpt, mesh):
    """The exact ``'structured'`` step recorded on ``mesh`` (its ``ppermute``
    ring and gathers inside the graph across ranks): 3 steps on a 3,000-row
    mesh problem, called three times (eager warm-up, recorded, replayed),
    the replay against an eager run (``graphs.uncaptured()``)."""
    import torch

    from nonlinpdes_gpsolver_tpu_torch.ops import graphs
    from nonlinpdes_gpsolver_tpu_torch.parallel import comm
    from nonlinpdes_gpsolver_tpu_torch.solvers.distributed import (
        factorize_distributed, gn_solve_distributed)

    w = tpt.workloads.mesh_elliptic(device=mesh.device, n_domain=1300, n_boundary=400)
    fp = factorize_distributed(w.problem, mesh, nugget=1e-5, block=256)
    kw = dict(max_iter=3, step_solver="structured")
    gn_solve_distributed(fp, **kw)
    graphs.reset_counts()
    comm.reset_counts()
    gn_solve_distributed(fp, **kw)
    out = {"captures": graphs.CAPTURES, "recorded_collectives": comm.RECORDED}
    graphs.reset_counts()
    st = gn_solve_distributed(fp, **kw)
    out.update(replays=graphs.REPLAYS, replay_captures=graphs.CAPTURES)
    with graphs.uncaptured():
        ref = gn_solve_distributed(fp, **kw)
    out["bitwise"] = bool(torch.equal(st.z, ref.z) and torch.equal(st.losses, ref.losses))
    return out


def _z_diff(tmp, name, z1):
    import torch

    z = torch.load(os.path.join(tmp, name))
    return float((z - z1.cpu()).abs().max() / z1.abs().max())


def mesh_ranks(dev, p1, sizes=FULL_SIZES, world=2):
    """Phase ``mesh_ranks``: ``world`` ranks sharing one card over gloo
    (:func:`mesh_ranks_rank`), beside the one-device runs ``p1`` of the same
    call (``mesh_solve``'s report and solution, ``mesh_darcy``'s report):
    every gate, test L2 within 10% of the one-device run's, z within
    ``Z_REL_GATE`` of its scale from it, and the steps within 1e-6 of
    ``'direct'``."""
    with tempfile.TemporaryDirectory() as tmp:
        spawn_ranks(mesh_ranks_rank, world, tmp, str(dev), sizes)
        ranks = [_read(tmp, f"rank{r}.json") for r in range(world)]
        z_rel = _z_diff(tmp, "z_mesh_elliptic.pt", p1["z"])
    ell = [r["mesh_elliptic"] for r in ranks]
    dar = [r["darcy_past_wall"] for r in ranks]
    for rep, name in ((ell[0], "mesh_elliptic"), (dar[0], "darcy_past_wall")):
        check(not rep["failures"], f"{name} at {world} ranks: " + "; ".join(rep["failures"]))
        check(rep["converged_finite"], f"{name} at {world} ranks: a GN step had no finite trial")
    # 'auto' past the panel cap of 4,096 latent columns a rank (at full size)
    wide = lambda m: -(-m // world) > 4096  # noqa: E731
    for rep, m, past in ((ell[0], sizes["mesh_elliptic"][0], "cg"),
                         (dar[0], 6 * sizes["darcy_past_wall"], "woodbury")):
        want = past if wide(m) else "structured"
        check(rep["step_solver"] == want, f"{m} latents at {world} ranks took {rep['step_solver']}")
    for rep, one, key in ((ell[0], p1["mesh_solve"], "test_l2"),
                          (dar[0], p1["mesh_darcy"], "test_l2"),
                          (dar[0], p1["mesh_darcy"], "a_rel_l2")):
        a, b = rep["metrics"][key], one["metrics"][key]
        check(abs(a - b) <= 0.1 * b, f"{key} {a:.4e} at {world} ranks, {b:.4e} on one device")
    check(z_rel <= Z_REL_GATE, f"mesh_elliptic z at {world} ranks {z_rel:.3e} of its scale "
          "from one device")
    for r in ranks:
        check(dev.type != "cuda" or (r["mesh_elliptic"]["k1_launches"] > 0
                                     and r["mesh_elliptic"]["k2_launches"] > 0),
              f"rank {r['rank']} launched K1/K2 {r['mesh_elliptic']['k1_launches']}/"
              f"{r['mesh_elliptic']['k2_launches']} times")
        for name, case in r["mesh_steps"].items():
            check(case["z_rel_diff"] <= 1e-6,
                  f"rank {r['rank']} steps {name}: {case['z_rel_diff']:.3e}")
    return {"ranks": ranks, "z_rel_diff_to_one_device": z_rel}


def mesh_nccl(dev, z1, sizes=FULL_SIZES, backend="nccl", world=None):
    """Phase ``mesh_nccl``: one rank per visible card over ``backend``
    (:func:`mesh_nccl_rank`): the 16,200-row problem's gate, and its
    solution within ``Z_REL_GATE`` of the one-device run's ``z1`` of the
    same call. On the card each rank's loop is recorded with its NCCL
    collectives inside (a group of one too): the warm solve rebinds and
    replays; the loop replayed gives the bits of its eager run, with no
    capture, no host agreement but the route's one and the normal budget's
    (set-up reads), and the P = 1 count of host reads; a second problem
    rebinds with no capture and gives the bits of its unshared solve; a
    third live problem is a guest on every rank, whose guest entry records
    its loop with the collectives and replays it, the bits of its unshared
    solve; the exact ``'structured'`` step is recorded with its ring and replayed,
    bitwise its eager run (:func:`exact_step_recorded`). On the CPU (a
    rehearsal) ``world`` ranks, 1 by default."""
    import torch

    if world is None:
        world = torch.cuda.device_count() if dev.type == "cuda" else 1
    device = None if dev.type == "cuda" else str(dev)
    with tempfile.TemporaryDirectory() as tmp:
        spawn_ranks(mesh_nccl_rank, world, tmp, backend, sizes, device)
        ranks = [_read(tmp, f"rank{r}.json") for r in range(world)]
        z_rel = _z_diff(tmp, "z_nccl.pt", z1)
    for r in ranks:
        who = f"mesh_nccl rank {r['rank']}"
        check(r["test_l2"] <= GATE_L2, f"{who}: test L2 {r['test_l2']:.4e}")
        check(dev.type != "cuda" or (r["k1_launches"] > 0 and r["k2_launches"] > 0),
              f"{who} launched K1/K2 {r['k1_launches']}/{r['k2_launches']}")
        check(r["converged_finite"], f"{who}: a GN step had no finite trial")
        check(r["backend"] == backend, f"mesh_nccl ran over {r['backend']}")
        check(r["collectives"] > 0, f"{who} made no {backend} collective")
        gn, second = r["gn"], r["second"]
        check(gn["bitwise"] and gn["solve_bitwise"],
              f"{who}: the replayed loop differs from its eager run or from the solve")
        check(second["unshared_bitwise"], f"{who}: the rebound solve differs from its unshared one")
        check(second["rebinds"] == 1 and second["entries"] == 0,
              f"{who}: the second problem bound {second}")
        guest = r["guest"]
        check(guest["guests"] == 1 and guest["guest_loads"] == 1 and not guest["bound"]
              and guest["entries"] == guest["rebinds"] == 0 and guest["live_entries"] == 3,
              f"{who}: the third live problem bound {guest}")
        check(guest["unshared_bitwise"], f"{who}: the guest's solve differs from its unshared one")
        check(guest["test_l2"] <= GATE_L2, f"{who}: the guest's test L2 {guest['test_l2']:.4e}")
        exact = r["exact"]
        check(exact["bitwise"], f"{who}: the replayed 'structured' step differs from its eager run")
        rep = gn["replayed"]
        check(rep["host_reads"] == rep["expected_host_reads"],
              f"{who}: {rep['host_reads']} host reads, {rep['expected_host_reads']} at P = 1")
        check(rep["host_agreements"] <= 2, f"{who}: {rep['host_agreements']} host agreements")
        if dev.type == "cuda":
            check(r["cold"]["captures"] > 0 and r["cold"]["recorded_collectives"] > 0,
                  f"{who}: the cold solve recorded {r['cold']} (graphs, NCCL collectives)")
            for what in (r["warm"], rep, second):
                check(what["captures"] == 0 and what["replays"] > 0,
                      f"{who}: recorded {what['captures']}, replayed {what['replays']} graphs")
            check(guest["captures"] > 0 and guest["recorded_collectives"] > 0
                  and guest["replays"] > 0,
                  f"{who}: the guest entry's loop recorded and replayed {guest}")
            check(exact["captures"] > 0 and exact["recorded_collectives"] > 0
                  and exact["replay_captures"] == 0 and exact["replays"] > 0,
                  f"{who}: the 'structured' step recorded and replayed {exact}")
    check(z_rel <= Z_REL_GATE, f"mesh_nccl z {z_rel:.3e} of its scale from one device")
    return {"ranks": ranks, "z_rel_diff_to_one_device": z_rel}


# -- checkpoint, the reference-API facade and perf_report -----------------------------

REPO = os.path.dirname(os.path.abspath(__file__))
FLOP_MODEL_NOTE = ("TFLOP/s by the JAX package's FLOP model (utils/profiling.py::flop_model: "
                   "n^3/3 a Cholesky over the factorize seconds, the dense GN count over the "
                   "gauss_newton seconds): the model's count, not the port's work, and not a "
                   "roofline share")
BLOCKED = ("jax", "jaxlib", "nonlinpdes_gpsolver_tpu")


def model_tflops(problem, phase_seconds, gn_steps):
    """Each phase's TFLOP/s by the JAX package's FLOP model (:data:`FLOP_MODEL_NOTE`)."""
    from nonlinpdes_gpsolver_tpu_torch.utils.profiling import flop_model, tflops

    fm = flop_model(problem, gn_iters=gn_steps)
    return {"model": FLOP_MODEL_NOTE, "flops": fm,
            "factorize": tflops(fm["cholesky"], phase_seconds["factorize"]),
            "gauss_newton": tflops(fm["gn_total"], phase_seconds["gauss_newton"])}


def large_problem(tpt, dev, sizes=(7800, 600), seed=0):
    """Phase 4's problem, 16,200 Gram rows: N_domain 7800 and N_boundary 600
    from the port's sampler (seed ``seed``, 0 in phase 4), sigma 0.2, the
    latent of seed ``seed + 1`` (``sizes``: smaller, for a rehearsal on the
    CPU)."""
    import torch

    Xd, Xb = tpt.utils.sample_random(torch.Generator(device=dev).manual_seed(seed), *sizes)
    return tpt.models.nonlinear_elliptic(tpt.SquaredExponential.gaussian(0.2), Xd, Xb,
                                         tpt.workloads.elliptic_rhs(), tpt.workloads.u_elliptic,
                                         seed=seed + 1)


def sha256_of(t):
    import hashlib

    return hashlib.sha256(t.detach().cpu().contiguous().numpy().tobytes()).hexdigest()


def checkpoint_dense(tpt, fp, state, Xt, truth):
    """Phase checkpoint (a): the canonical solve's factor and 4-step state
    through ``save_solver_state`` and ``load_solver_state``: the factor and z
    bitwise, 2 GN steps resumed from the loaded z to a loss at most 1.01
    times the saved last loss, and the extension to the 60x60 grid through
    the reloaded factor equal to the original's, in one K1 launch, under
    the gate."""
    import torch

    from nonlinpdes_gpsolver_tpu_torch.utils import checkpoint

    dev = fp.problem.device
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "canonical.npz")
        sync(dev)
        t0 = time.perf_counter()
        checkpoint.save_solver_state(path, fp, state)
        out["save_seconds"] = time.perf_counter() - t0
        out["file_bytes"] = os.path.getsize(path)
        t0 = time.perf_counter()
        fp2, st2 = checkpoint.load_solver_state(path, fp.problem)
        sync(dev)
        out["load_seconds"] = time.perf_counter() - t0
    out["factor_bitwise"] = all(torch.equal(fp2.factors[k], fp.factors[k]) for k in fp.factors)
    out["inv_factor_bitwise"] = all(torch.equal(fp2.inv_factors[k], fp.inv_factors[k])
                                    for k in fp.inv_factors)
    out["z_bitwise"] = torch.equal(st2.z, state.z)
    check(out["factor_bitwise"] and out["inv_factor_bitwise"] and out["z_bitwise"],
          "checkpoint: the dense round trip is not bitwise")
    resumed = tpt.gn_solve(fp2, z0=st2.z, max_iter=2)
    out["saved_last_loss"] = float(st2.losses[-1])
    out["resumed_losses"] = resumed.losses.tolist()
    check(out["resumed_losses"][-1] <= 1.01 * out["saved_last_loss"],
          f"checkpoint: resumed loss {out['resumed_losses'][-1]:.4e} > 1.01 x "
          f"{out['saved_last_loss']:.4e}")
    original = tpt.Posterior(fp, state.z).extend(Xt)
    sync(dev)
    zero_counts()
    pred = tpt.Posterior(fp2, st2.z).extend(Xt)
    sync(dev)
    out["k1_launches"] = counts()[0]
    out["extension_equal"] = torch.equal(pred, original)
    out["test_l2"] = tpt.GPSolver.errors(pred, truth).l2
    check(dev.type != "cuda" or out["k1_launches"] == 1,
          f"checkpoint: the extension launched K1 {out['k1_launches']} times")
    check(out["extension_equal"], "checkpoint: the reloaded extension differs from the original's")
    check(out["test_l2"] <= GATE_L2, f"checkpoint: test L2 {out['test_l2']:.4e} > {GATE_L2}")
    return out


def checkpoint_child(path, aux, out_path):
    """Phase checkpoint (b), in a child process that imports the port only
    (jax and the JAX package blocked): reload the 16,200-row mesh factor and
    state saved by the parent, check the factor bitwise (its sha256), its
    diagonal-block inverses bitwise (the file holds them) and the whitened
    residual within 1e-6 of its scale of the saved run's, resume 2 GN steps,
    and extend to the 60x60 grid with K1's launches counted, under the gate."""
    import importlib.abc
    import sys

    class Block(importlib.abc.MetaPathFinder):
        def find_spec(self, name, path=None, target=None):
            if name.split(".")[0] in BLOCKED:
                raise ImportError("blocked in the checkpoint child: " + name)

    sys.meta_path.insert(0, Block())
    t_start = time.perf_counter()
    import torch

    import nonlinpdes_gpsolver_tpu_torch as tpt
    from nonlinpdes_gpsolver_tpu_torch.parallel import make_mesh
    from nonlinpdes_gpsolver_tpu_torch.solvers.distributed import (
        DistributedPosterior, gn_solve_distributed,
    )

    saved = torch.load(aux)
    dev = torch.device(saved["device"])
    prob = large_problem(tpt, dev, saved["sizes"])
    Xt = tpt.utils.test_grid(60, 60, device=dev)
    truth = torch.func.vmap(tpt.workloads.u_elliptic)(Xt)
    sync(dev)
    t0 = time.perf_counter()
    dfp, st = tpt.utils.load_distributed_state(path, prob, make_mesh(1, device=dev))
    sync(dev)
    out = {"load_seconds": time.perf_counter() - t0}
    fac = dfp.factors["u"]
    out["factor_bitwise"] = sha256_of(fac.local) == saved["sha256"]
    out["z_bitwise"] = torch.equal(st.z.cpu(), saved["z"])
    r = dfp.whitened_residual(st.z).cpu()
    out["residual_rel_diff"] = float((r - saved["r"]).abs().max() / saved["r"].abs().max())
    out["diag_inv_bitwise"] = torch.equal(fac.diag_inv.cpu(), saved["diag_inv"])
    out["saved_last_loss"] = float(st.losses[-1])
    t0 = time.perf_counter()
    resumed = gn_solve_distributed(dfp, z0=st.z, max_iter=2)
    sync(dev)
    out["resume_seconds"] = time.perf_counter() - t0
    out["resumed_losses"] = resumed.losses.tolist()
    out["step_solver"] = resumed.step_solver
    out["cg_iters"] = resumed.cg_iters.tolist()
    zero_counts()
    t0 = time.perf_counter()
    pred = DistributedPosterior(dfp, resumed.z).extend(Xt)
    sync(dev)
    out["extension_seconds"] = time.perf_counter() - t0
    out["k1_launches"] = counts()[0]
    out["test_l2"] = tpt.GPSolver.errors(pred, truth).l2
    out["child_seconds"] = time.perf_counter() - t_start
    out["jax_imported"] = [m for m in sys.modules if m.split(".")[0] in BLOCKED]
    _write(os.path.dirname(out_path), os.path.basename(out_path), out)


def checkpoint_mesh(dfp, state, factorize_seconds, sizes=(7800, 600)):
    """Phase checkpoint (b): ``mesh_vs_dense``'s 16,200-row mesh factor and
    4-step state (of :func:`large_problem` at ``sizes``) saved, then
    reloaded in a child process (:func:`checkpoint_child`); the file's bytes
    and the save and load seconds beside phase 9's factorize seconds."""
    import sys

    import torch

    from nonlinpdes_gpsolver_tpu_torch.utils import checkpoint

    fac = dfp.factors["u"]
    dev = fac.local.device
    out = {"gram_rows": fac.n, "n_pad": fac.n_pad, "block": fac.block,
           "factorize_seconds_phase_9": factorize_seconds}
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "mesh.npz")
        sync(dev)
        t0 = time.perf_counter()
        checkpoint.save_distributed_state(path, dfp, state)
        out["save_seconds"] = time.perf_counter() - t0
        out["file_bytes"] = os.path.getsize(path)
        out["factor_bytes"] = fac.local.numel() * fac.local.element_size()
        aux = os.path.join(tmp, "saved.pt")
        torch.save({"sha256": sha256_of(fac.local), "z": state.z.cpu(),
                    "r": dfp.whitened_residual(state.z).cpu(), "diag_inv": fac.diag_inv.cpu(),
                    "device": str(dev), "sizes": tuple(sizes)}, aux)
        child_out = os.path.join(tmp, "child.json")
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--checkpoint-child",
                               path, aux, child_out], capture_output=True, text=True, timeout=600)
        out["child_process_seconds"] = time.perf_counter() - t0
        check(proc.returncode == 0, f"checkpoint child failed:\n{proc.stderr[-4000:]}")
        child = _read(tmp, "child.json")
    out["child"] = child
    out["reload_faster_than_refactorize"] = child["load_seconds"] < factorize_seconds
    check(not child["jax_imported"], f"checkpoint child imported {child['jax_imported']}")
    check(child["factor_bitwise"] and child["z_bitwise"] and child["diag_inv_bitwise"],
          "checkpoint: mesh factor, its diagonal-block inverses or z not bitwise")
    check(child["residual_rel_diff"] <= 1e-6,
          f"checkpoint: whitened residual {child['residual_rel_diff']:.3e} of its scale apart")
    check(child["resumed_losses"][-1] <= 1.01 * child["saved_last_loss"],
          f"checkpoint: mesh resumed loss {child['resumed_losses'][-1]:.4e} > 1.01 x "
          f"{child['saved_last_loss']:.4e}")
    check(dev.type != "cuda" or child["k1_launches"] > 0,
          "checkpoint: the mesh extension launched no K1")
    check(child["test_l2"] <= GATE_L2, f"checkpoint: mesh test L2 {child['test_l2']:.4e}")
    return out


def compat_phase(tpt, inp, Xt, truth, device=None):
    """Phase compat: the reference-API flow of ``solver_GP`` on the card
    (no ``cfg.device``: the card, f32; ``device``: there, for a rehearsal):
    ``set_equation``, ``get_sample`` on the canonical draw's points,
    ``solve(method="elimination")`` (nugget 1e-5, 4 GN steps from the
    facade's seed-1 random start), ``test`` on the 60x60 grid and
    ``get_test_error``: 2 K1 launches, under the gate."""
    import argparse

    from nonlinpdes_gpsolver_tpu_torch.compat import solver_GP

    cfg = argparse.Namespace(kernel="Gaussian", kernel_parameter=0.2, nugget=1e-5, GNsteps=4,
                             initial_sol="rdm", randomseed=1, print_hist=False)
    if device is not None:
        cfg.device = device
    solver = solver_GP(cfg, PDE_type="Nonlinear_elliptic")
    solver.set_equation(bdy=tpt.workloads.u_elliptic, rhs=tpt.workloads.elliptic_rhs())
    solver.get_sample(inp["X_domain"], inp["X_boundary"])
    dev = solver._X_domain.device
    sync(dev)
    zero_counts()
    t0 = time.perf_counter()
    solver.solve(method="elimination")
    pred = solver.test(Xt)
    sync(dev)
    seconds = time.perf_counter() - t0
    launches = counts()[0]
    stats = solver.get_test_error(truth, print_option=False)
    out = {"device": str(pred.device), "dtype": str(pred.dtype).split(".")[1],
           "solve_and_test_seconds": seconds, "k1_launches": launches, "test_l2": stats.l2,
           "test_max": stats.max, "losses": [float(v) for v in solver.loss_hist],
           "timers": solver._result.timers}
    check(device is not None or pred.is_cuda, "compat: the facade did not run on the card")
    check(not pred.is_cuda or launches == 2, f"compat: K1 launched {launches} times, expected 2")
    check(stats.l2 <= GATE_L2, f"compat: test L2 {stats.l2:.4e} > {GATE_L2}")
    return out


PERF_REPORT_RUNS = (["--workload", "elliptic", "--sizes", "900", "7800", "--warm"],
                    ["--workload", "elliptic", "--mesh", "1", "--sizes", "7800", "--warm"])


def perf_report_phase(runs_argv=PERF_REPORT_RUNS, extra=()):
    """Phase perf_report: the port's driver
    (``python -m nonlinpdes_gpsolver_tpu_torch.examples.perf_report``) as a
    subprocess on the card, once per :data:`PERF_REPORT_RUNS` (``extra``
    arguments appended: ``--device cpu`` for a rehearsal); its table rows,
    each with a finite test L2."""
    import sys

    runs = []
    for argv in runs_argv:
        argv = [*argv, *extra]
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, "-m", "nonlinpdes_gpsolver_tpu_torch.examples."
                               "perf_report", *argv], cwd=REPO, capture_output=True, text=True,
                              timeout=600)
        check(proc.returncode == 0, f"perf_report {argv} failed:\n{proc.stderr[-4000:]}")
        lines = proc.stdout.splitlines()
        head = next(i for i, ln in enumerate(lines) if ln.split()[:2] == ["N", "factor_s"])
        rows = lines[head + 1 :]
        cols = lines[head].split()
        parsed = [dict(zip(cols, map(float, ln.split()[: len(cols)]))) for ln in rows]
        after = argv[argv.index("--sizes") + 1 :]
        sizes = next((j for j, a in enumerate(after) if a.startswith("--")), len(after))
        check(len(parsed) == sizes and all(math.isfinite(r["test_L2"]) for r in parsed),
              f"perf_report {argv}: rows {rows}")
        runs.append({"argv": argv, "process_seconds": time.perf_counter() - t0,
                     "lines": lines[: head + 1] + rows, "rows": parsed})
    return runs


def main():
    t_start = time.perf_counter()
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false; no result")
    import numpy as np

    import nonlinpdes_gpsolver_tpu_torch as tpt
    from nonlinpdes_gpsolver_tpu_torch.ops import _build, gram_tile, graphs
    from nonlinpdes_gpsolver_tpu_torch.ops.operators import d, d2, identity, laplacian

    dev = torch.device("cuda")
    u_truth, rhs_f = tpt.workloads.u_elliptic, tpt.workloads.elliptic_rhs()
    card = smi("name,power.limit")
    emit("device", nvidia_smi=card, torch=torch.__version__, cuda=torch.version.cuda,
         kind=torch.cuda.get_device_name(0), count=torch.cuda.device_count())

    # -- 1. build ---------------------------------------------------------------
    t0 = time.perf_counter()
    gram_tile._kernel_lib()
    build_s = time.perf_counter() - t0
    log_path = str(_build.library_path("gram_tile")) + ".log"
    with open(log_path) as fh:
        ptxas = [ln.strip() for ln in fh
                 if "entry function" in ln or "registers" in ln or "spill" in ln]
    emit("build", kernel="gram_tile", seconds=build_s, ptxas=ptxas, k2_ptxas=k2_ptxas(ptxas))

    # -- 1b. the row-block triangular-solve kernel -------------------------------
    t0 = time.perf_counter()
    from nonlinpdes_gpsolver_tpu_torch.ops import trsm_rowblock
    trsm_rowblock._kernel_lib()
    trsm_build_s = time.perf_counter() - t0
    with open(str(_build.library_path("trsm_rowblock")) + ".log") as fh:
        trsm_ptxas = [ln.strip() for ln in fh
                      if "entry function" in ln or "registers" in ln or "spill" in ln]
    t_phase = time.perf_counter()
    trsm = trsm_rowblock_phase(tpt, dev)
    emit("trsm_rowblock", build_seconds=trsm_build_s, ptxas=trsm_ptxas,
         seconds=time.perf_counter() - t_phase, card=card, **trsm)

    # -- 1c. the 'normal' step's equilibrated normal-matrix kernel ---------------
    t0 = time.perf_counter()
    from nonlinpdes_gpsolver_tpu_torch.ops import normal_matrix
    normal_matrix._kernel_lib()
    normal_build_s = time.perf_counter() - t0
    with open(str(_build.library_path("normal_matrix")) + ".log") as fh:
        normal_ptxas = [ln.strip() for ln in fh
                        if "entry function" in ln or "registers" in ln or "spill" in ln]
    t_phase = time.perf_counter()
    normal = normal_matrix_phase(tpt, dev)
    emit("normal_matrix", build_seconds=normal_build_s, ptxas=normal_ptxas,
         seconds=time.perf_counter() - t_phase, card=card, **normal)

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

    def check_assembly(what, plan, sets, limit):
        """One launch of ``plan`` against the plain per-block assembly on the
        same inputs; Theta-like plans must come out exactly symmetric."""
        before = gram_tile.LAUNCHES
        got = plan.run(sets)
        torch.cuda.synchronize()
        check(gram_tile.LAUNCHES == before + 1, f"{what}: not one launch")
        ref = torch.zeros_like(got)
        plan._plain(sets, ref)
        rel, diff = blockwise_rel_err(plan, got, ref)
        check(math.isfinite(rel) and rel <= limit, f"{what}: {rel:.3e} > {limit}")
        symmetric = None
        if any(b.mirror or b.symmetric for b in plan.blocks):
            symmetric = bool(torch.equal(got, got.T))
            check(symmetric, f"{what}: Theta is not exactly symmetric")
        return {"what": what, "shape": list(got.shape), "dtype": str(got.dtype).split(".")[1],
                "blocks": len(plan.blocks), "rel_err": rel, "max_abs_err": diff,
                "exactly_symmetric": symmetric}

    ragged_obs = (
        tpt.ops.Observable("a", laplacian()), tpt.ops.Observable("a", identity()),
        tpt.ops.Observable("b", d(0)), tpt.ops.Observable("b", identity()),
        tpt.ops.Observable("c", d2(1, 1)),
    )
    ragged_np = {"a": rng.uniform(0, 1, (65, 2)), "b": rng.uniform(0, 1, (33, 2)),
                 "c": rng.uniform(0, 1, (7, 2))}
    Xq = rng.uniform(0, 1, (97, 2))
    ragged_rows = []
    for dtype, limit in limits.items():
        pts = {k: torch.as_tensor(v, dtype=dtype, device=dev) for k, v in ragged_np.items()}
        sizes = tpt.ops.observable_sizes(ragged_obs, pts)
        for kn, k in kernels.items():
            plan = gram_tile.gram_plan(k, ragged_obs, sizes)
            sets = [pts[key] for key in plan.set_keys]
            ragged_rows.append(check_assembly(f"ragged Theta {kn}", plan, sets, limit))
            cplan = gram_tile.cross_plan(k, laplacian(), 97, ragged_obs, sizes)
            csets = [torch.as_tensor(Xq, dtype=dtype, device=dev), *sets]
            ragged_rows.append(check_assembly(f"ragged cross-Gram {kn}", cplan, csets, limit))
            n = plan.shape[0]
            big = torch.full((n + 9, n + 21), 7.0, dtype=dtype, device=dev)
            plan.run(sets, out=big[4 : 4 + n, 13 : 13 + n])
            check(bool(torch.equal(big[4 : 4 + n, 13 : 13 + n], plan.run(sets))),
                  f"ragged Theta {kn} {dtype}: strided slot differs")
            big[4 : 4 + n, 13 : 13 + n] = 7.0
            check(bool((big == 7.0).all()), f"ragged Theta {kn} {dtype}: wrote outside its slot")
    emit("k1_one_launch_ragged", sizes=[65, 33, 7], cases=ragged_rows, strided_slot="checked")

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
    repeats, repeat_binds = [], []  # the spread of the warm time, the warm result alive
    for _ in range(5):
        graphs.reset_counts()
        t0 = time.perf_counter()
        canonical()
        torch.cuda.synchronize()
        repeats.append(time.perf_counter() - t0)
        repeat_binds.append(bound_as())
    emit("canonical_solve", n_domain=900, n_boundary=124, gram_rows=1924, dtype="float32",
         nugget=1e-5, gn_steps=4, e2e_seconds=warm_s, cold_seconds=cold_s,
         repeat_e2e_seconds=repeats, repeat_binds=repeat_binds,
         phase_seconds=res.timers, test_l2=err.l2, test_max=err.max,
         nugget_scales=res.posterior.fp.nugget_scales, rungs=res.posterior.fp.rungs,
         losses=res.state.losses.tolist(), k1_launches=launches, gate_l2=GATE_L2)
    check(launches == 2, f"canonical solve launched K1 {launches} times, expected 2")
    check(err.l2 <= GATE_L2, f"canonical test L2 {err.l2:.4e} > {GATE_L2}")
    check(bool(res.state.converged_finite), "canonical GN rejected a step")
    canon_fp, canon_state = res.posterior.fp, res.state  # phase checkpoint's dense case

    def main_path_assemblies(problem, X_test, dtype=None, extended=("u",)):
        """(name, plan, point sets) of the K1 launches of a solve: each
        block's training Gram, then the test cross-Gram of each block in
        ``extended``, optionally cast."""
        pts = problem.points
        if dtype is not None:
            pts = {k: v.to(dtype) for k, v in pts.items()}
            X_test = X_test.to(dtype)
        out, cross = [], []
        for blk in problem.blocks:
            obs = blk.observables
            sizes = tpt.ops.observable_sizes(obs, pts)
            plan = gram_tile.gram_plan(blk.kernel, obs, sizes)
            sets = [pts[k] for k in plan.set_keys]
            out.append((f"training Gram {blk.name}", plan, sets))
            if blk.name in extended:
                cplan = gram_tile.cross_plan(blk.kernel, identity(), int(X_test.shape[0]), obs, sizes)
                cross.append((f"test cross-Gram {blk.name}", cplan, [X_test, *sets]))
        return out + cross

    def time_assemblies(problem, X_test, reps, plain_reps, extended=("u",)):
        """Check every assembly in f32 and f64; time them in f32."""
        out, checks = [], []
        for dtype, limit in limits.items():
            for name, plan, sets in main_path_assemblies(problem, X_test, dtype, extended):
                checks.append(check_assembly(name, plan, sets, limit))
        for (name, plan, sets), chk in zip(main_path_assemblies(problem, X_test, extended=extended),
                                           checks):
            bound, by = k1_bound_ms(plan, "float32")
            buf = torch.empty(plan.shape, dtype=sets[0].dtype, device=dev)
            ms = time_ms(lambda: plan.run(sets, out=buf), reps)
            out.append({"assembly": name, "shape": list(plan.shape), "blocks": len(plan.blocks),
                        "tiles": plan.n_tiles, "ms": ms,
                        "host_us_per_call": host_us(lambda: plan.run(sets, out=buf), reps),
                        "plain_ms": time_ms(lambda: plan._plain(sets, buf), plain_reps),
                        "bound_ms": bound, "bound_by": by, "share_of_bound": bound / ms,
                        "max_abs_err": chk["max_abs_err"], "rel_err": chk["rel_err"]})
            del buf
        return out, checks

    gm_host = host_us(lambda: tpt.ops.gram_matrix(prob.blocks[0].kernel, prob.blocks[0].observables,
                                                  prob.points), 200)
    canon_asm, canon_checks = time_assemblies(prob, Xt, 50, 10)
    canon_abs = max(c["max_abs_err"] for c in canon_checks if c["dtype"] == "float32")
    emit("k1_canonical_assemblies", card=card, assemblies=canon_asm, checks=canon_checks,
         gram_matrix_host_us_per_call=gm_host)

    # -- 4. largest dense solve ------------------------------------------------
    del prob, res
    kernel = tpt.SquaredExponential.gaussian(0.2)
    t0 = time.perf_counter()
    big = large_problem(tpt, dev)
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
        graphs.reset_counts()
        t0 = time.perf_counter()
        r, _, _ = large()
        torch.cuda.synchronize()
        big_repeats.append({"e2e_seconds": time.perf_counter() - t0, "phase_seconds": r.timers,
                            "bind": bound_as()})
        del r
    finite = bool(torch.isfinite(big_pred).all()) and bool(torch.isfinite(big_res.z).all())
    emit("large_solve", n_domain=7800, n_boundary=600, gram_rows=16200, dtype="float32",
         nugget=1e-5, gn_steps=4, problem_seconds=problem_s, cold_seconds=big_cold_s,
         e2e_seconds=big_s, phase_seconds=big_res.timers, repeats=big_repeats,
         max_memory_allocated=peak, test_l2=big_err.l2, test_max=big_err.max, finite=finite,
         nugget_scales=big_res.posterior.fp.nugget_scales, rungs=big_res.posterior.fp.rungs,
         losses=big_res.state.losses.tolist(), k1_launches=big_launches, card=card,
         flop_model_tflops=model_tflops(big, big_res.timers, 4))
    check(finite, "large solve produced non-finite values")
    check(big_err.l2 <= GATE_L2, f"large test L2 {big_err.l2:.4e} > {GATE_L2}")
    check(big_launches == 2, f"large solve launched K1 {big_launches} times, expected 2")

    big_res_timers = big_res.timers
    del big_res, big_pred
    big_asm, big_checks = time_assemblies(big, Xt, 5, 2)
    big_abs = max(c["max_abs_err"] for c in big_checks if c["dtype"] == "float32")
    # the largest block alone, as a one-block launch (full, not symmetric)
    Xdd = big.points["domain"]
    lap_plan = gram_tile.pair_plan(kernel, laplacian(), laplacian(), Xdd.shape[0], Xdd.shape[0])
    lap_chk = check_assembly("7800^2 lap x lap block", lap_plan, [Xdd, Xdd], limits[torch.float32])
    lap_buf = torch.empty(lap_plan.shape, dtype=Xdd.dtype, device=dev)
    lap_ms = time_ms(lambda: lap_plan.run([Xdd, Xdd], out=lap_buf), 20)
    lap_bound, lap_by = k1_bound_ms(lap_plan, "float32")
    del lap_buf
    emit("k1_large_assemblies", card=card, assemblies=big_asm, checks=big_checks,
         lap_block={"shape": list(lap_plan.shape), "ms": lap_ms, "bound_ms": lap_bound,
                    "bound_by": lap_by, "share_of_bound": lap_bound / lap_ms,
                    "rel_err": lap_chk["rel_err"]})

    # -- 5. the other reference workloads ----------------------------------------
    del big
    torch.cuda.empty_cache()
    wl_summary = {}
    for name, expected in WORKLOAD_LAUNCHES.items():
        t0 = time.perf_counter()
        w = tpt.workloads.WORKLOADS[name](device=dev)
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0

        def run(w=w):
            res = w.solve()
            return res, w.metrics(res)

        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        w_cold = time.perf_counter() - t0
        torch.cuda.reset_peak_memory_stats()
        gram_tile.LAUNCHES = 0
        t0 = time.perf_counter()
        res, metrics = run()
        torch.cuda.synchronize()
        w_warm = time.perf_counter() - t0
        w_launches = gram_tile.LAUNCHES
        w_peak = torch.cuda.max_memory_allocated()
        w_repeats = []
        for _ in range(3):
            graphs.reset_counts()
            t0 = time.perf_counter()
            r, _ = run()
            torch.cuda.synchronize()
            w_repeats.append({"e2e_seconds": time.perf_counter() - t0, "phase_seconds": r.timers,
                              "bind": bound_as()})
            del r
        fp = res.posterior.fp
        emit("workload", name=name, dtype="float32", card=card,
             gram_rows={b: int(f.shape[0]) for b, f in fp.factors.items()},
             latent_dim=w.problem.latent_dim, nugget=w.nugget, gn_steps=w.max_iter,
             build_seconds=build_s, cold_seconds=w_cold, e2e_seconds=w_warm,
             phase_seconds=res.timers, repeats=w_repeats, metrics=metrics, gates=w.gates,
             nugget_scales=fp.nugget_scales, rungs=fp.rungs, losses=res.state.losses.tolist(),
             converged_finite=bool(res.state.converged_finite), k1_launches=w_launches,
             max_memory_allocated=w_peak)
        failed = w.failures(metrics)
        check(not failed, "; ".join(failed))
        check(bool(res.state.converged_finite), f"{name}: a GN step was rejected")
        check(w_launches == expected, f"{name} launched K1 {w_launches} times, expected {expected}")
        del res
        extended = ("u", "a") if w.a_truth is not None else ("u",)
        w_asm, w_checks = time_assemblies(w.problem, w.X_test, 20, 3, extended)
        emit("k1_workload_assemblies", name=name, card=card, assemblies=w_asm, checks=w_checks)
        wl_summary[name] = {
            "launches": w_launches,
            "ms": sum(a["ms"] for a in w_asm),
            "plain_ms": sum(a["plain_ms"] for a in w_asm),
            "bound_ms": sum(a["bound_ms"] for a in w_asm),
            "max_abs_err": max(c["max_abs_err"] for c in w_checks if c["dtype"] == "float32"),
        }
        del w

    # -- 6. the Krylov steps against the exact ones ------------------------------
    t_krylov = time.perf_counter()
    krylov = krylov_steps(tpt, dev)
    emit("krylov_steps", seconds=time.perf_counter() - t_krylov, card=card, **krylov)

    # -- 7. the Gauss-Newton loop recorded and replayed ---------------------------
    t_phase = time.perf_counter()
    graphs_out = gn_graphs(tpt, dev)
    emit("gn_graphs", seconds=time.perf_counter() - t_phase, card=card, **graphs_out)
    torch.cuda.empty_cache()

    # -- 8. K2 against its plain version -----------------------------------------
    t_phase = time.perf_counter()
    k2 = k2_vs_plain(tpt, dev)
    emit("k2_vs_plain", seconds=time.perf_counter() - t_phase, card=card, limits=LIMITS, **k2)

    # -- 9. the mesh path past the dense wall, routed by auto_mesh --------------
    from nonlinpdes_gpsolver_tpu_torch.api import _AUTO_MESH_GRAM_ROWS, largest_gram_rows
    from nonlinpdes_gpsolver_tpu_torch.parallel import make_mesh

    t_phase = time.perf_counter()
    w = tpt.workloads.mesh_elliptic(device=dev)
    check(largest_gram_rows(w.problem) >= _AUTO_MESH_GRAM_ROWS, "mesh_elliptic is below the crossover")
    p1 = {}  # the one-device runs that mesh_ranks is held to
    mesh_solve = mesh_phase(w, 2, auto=True, keep=p1)
    check(mesh_solve["routed_to_mesh"], "auto_mesh did not route mesh_elliptic to the mesh path")
    mesh_solve["flop_model_tflops"] = model_tflops(w.problem, mesh_solve["phase_seconds"],
                                                   w.max_iter)
    blk = w.problem.blocks[0]
    k2_rows, k2_total = time_k2(window_cases(blk, w.problem.points, w.nugget), 5, 1)
    mesh_k1_rows, mesh_k1_total = time_k1(mesh_k1_cases(tpt, w.problem, w.X_test), 5, 1)
    emit("mesh_solve", seconds=time.perf_counter() - t_phase, card=card, workload=w.name,
         n_domain=20000, n_boundary=2500, dtype="float32", nugget=w.nugget, gn_steps=w.max_iter,
         gate_l2=GATE_L2, **mesh_solve, k2_windows=k2_rows, k2_total=k2_total,
         k1_launches_timed=mesh_k1_rows, k1_total=mesh_k1_total)
    check(mesh_solve["k2_launches"] > 0 and mesh_solve["k1_launches"] > 0,
          f"mesh_elliptic launched K1/K2 {mesh_solve['k1_launches']}/{mesh_solve['k2_launches']} times")
    del w
    torch.cuda.empty_cache()

    # -- 10. the 16,200-row problem of phase 4 on the mesh path ------------------
    t_phase = time.perf_counter()
    big = large_problem(tpt, dev)
    mesh1 = make_mesh(1, device=dev)

    def large_mesh():
        t0 = time.perf_counter()
        res = tpt.GPSolver(big, nugget=1e-5, mesh=mesh1).solve(max_iter=4)
        err = tpt.GPSolver.errors(res.posterior.extend(Xt), truth_t)
        sync()
        return res, err, time.perf_counter() - t0

    big_mesh_cold = large_mesh()[2]
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    res, err, secs = large_mesh()
    mvd_launches, mvd_peak = counts(), torch.cuda.max_memory_allocated()
    mvd_k2_rows, mvd_k2_total = time_k2(window_cases(big.blocks[0], big.points, 1e-5), 5, 1)
    mvd_k1_rows, mvd_k1_total = time_k1(mesh_k1_cases(tpt, big, Xt), 5, 1)
    emit("mesh_vs_dense", seconds=time.perf_counter() - t_phase, card=card, gram_rows=16200,
         dtype="float32", nugget=1e-5, gn_steps=4, mesh_cold_seconds=big_mesh_cold,
         mesh_e2e_seconds=secs, mesh_phase_seconds=res.timers, dense_e2e_seconds=big_s,
         dense_repeats=big_repeats, dense_phase_seconds=big_res_timers, test_l2=err.l2,
         dense_test_l2=big_err.l2, rungs=res.posterior.fp.rungs, cg_iters=res.state.cg_iters.tolist(),
         factor_stats=res.posterior.fp.stats, k1_launches=mvd_launches[0],
         k2_launches=mvd_launches[1], trsm_launches=mvd_launches[2], max_memory_allocated=mvd_peak,
         dense_max_memory_allocated=peak, auto_mesh_gram_rows=_AUTO_MESH_GRAM_ROWS,
         k2_windows=mvd_k2_rows, k2_total=mvd_k2_total, k1_launches_timed=mvd_k1_rows,
         k1_total=mvd_k1_total, flop_model_tflops=model_tflops(big, res.timers, 4))
    check(err.l2 <= GATE_L2, f"16,200 rows on the mesh path: test L2 {err.l2:.4e} > {GATE_L2}")
    z_mvd, l2_mvd = res.z.clone(), err.l2
    # phase checkpoint's mesh case: this factor and state
    mvd_fp, mvd_state, mvd_factorize_s = res.posterior.fp, res.state, res.timers["factorize"]
    del res, big
    torch.cuda.empty_cache()

    # -- 11. the Darcy inverse problem past the wall ------------------------------
    t_phase = time.perf_counter()
    w = tpt.workloads.darcy_past_wall(device=dev)
    mesh_darcy = mesh_phase(w, 0)
    check(mesh_darcy["step_solver"] == "woodbury", f"darcy_past_wall took {mesh_darcy['step_solver']}")
    check(mesh_darcy["trsm_launches"] > 0, "darcy_past_wall's warm solve launched no row-block solve")
    darcy_k1_rows, darcy_k1_total = time_k1(mesh_k1_cases(tpt, w.problem, w.X_test, ("u", "a")), 5, 1)
    darcy_k2_rows, darcy_k2_total = time_k2(
        [case for blk in w.problem.blocks for case in window_cases(blk, w.problem.points, w.nugget)],
        5, 1)
    emit("mesh_darcy", seconds=time.perf_counter() - t_phase, card=card, workload=w.name,
         n_domain=3000, n_boundary=750, n_data=60, dtype="float32", nugget=w.nugget,
         gn_steps=w.max_iter, gates=w.gates, latent_dim=w.problem.latent_dim, **mesh_darcy,
         k1_launches_timed=darcy_k1_rows, k1_total=darcy_k1_total, k2_windows=darcy_k2_rows,
         k2_total=darcy_k2_total)
    del w
    torch.cuda.empty_cache()

    # -- 12. every step solver of the mesh path against the dense 'direct' -------
    t_phase = time.perf_counter()
    steps = mesh_steps(tpt, dev)
    emit("mesh_steps", seconds=time.perf_counter() - t_phase, card=card, **steps)

    # -- 13. the mesh path on two ranks that share the card, over gloo -------------
    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    p1.update(mesh_solve=mesh_solve, mesh_darcy=mesh_darcy)
    ranks = mesh_ranks(dev, p1)
    emit("mesh_ranks", seconds=time.perf_counter() - t_phase, card=card, backend="gloo",
         shared_card=True, collectives="staged through host memory: not NVLink or NCCL times",
         one_device={k: {"metrics": p1[k]["metrics"], "phase_seconds": p1[k]["phase_seconds"],
                         "max_memory_allocated": p1[k]["max_memory_allocated"]}
                     for k in ("mesh_solve", "mesh_darcy")}, **ranks)

    # -- 14. one rank per card over NCCL ------------------------------------------
    t_phase = time.perf_counter()
    nccl = mesh_nccl(dev, z_mvd)
    emit("mesh_nccl", seconds=time.perf_counter() - t_phase, card=card, backend="nccl",
         world_size=len(nccl["ranks"]), one_device_test_l2=l2_mvd,
         note=("a group of one rank: one card is visible; its collectives run over NCCL "
               "('collectives' a rank in the warm solve), and the recorded Gauss-Newton "
               "steps hold theirs ('recorded_collectives' at the cold solve's capture)"
               if len(nccl["ranks"]) == 1 else "one rank per visible card"), **nccl)

    # -- 15. checkpoint: save and resume, dense and mesh ------------------------------
    t_phase = time.perf_counter()
    ck_dense = checkpoint_dense(tpt, canon_fp, canon_state, Xt, truth_t)
    del canon_fp, canon_state  # the canonical layout's entry is released for structure_reuse
    torch.cuda.empty_cache()
    ck_mesh = checkpoint_mesh(mvd_fp, mvd_state, mvd_factorize_s)
    del mvd_fp, mvd_state
    torch.cuda.empty_cache()
    emit("checkpoint", seconds=time.perf_counter() - t_phase, card=card, dtype="float32",
         format="np.savez_compressed, the JAX package's keys and meta_json",
         dense=ck_dense, mesh=ck_mesh)

    # -- 16. the reference-API facade ------------------------------------------------
    t_phase = time.perf_counter()
    compat = compat_phase(tpt, inp, Xt, truth_t)
    emit("compat", seconds=time.perf_counter() - t_phase, card=card, gate_l2=GATE_L2, **compat)

    # -- 17. the perf_report driver ---------------------------------------------------
    t_phase = time.perf_counter()
    report = perf_report_phase()
    emit("perf_report", seconds=time.perf_counter() - t_phase, card=card,
         tflops_note=FLOP_MODEL_NOTE, runs=report)

    # -- 18. new problems of one structure: one recorded loop ------------------------
    t_phase = time.perf_counter()
    reuse = structure_reuse(tpt, dev, sweep=SWEEP)
    emit("structure_reuse", seconds=time.perf_counter() - t_phase, card=card, runs=5,
         held_runs=6, two_pass_runs=3, sweep_runs=SWEEP, **reuse)

    # -- 19. summary ------------------------------------------------------------
    emit("done", seconds=time.perf_counter() - t_start, card=card)
    print(json.dumps({"kernels": [{
        "name": "gram_tile",
        "route": "cuda",
        "source": "nonlinpdes_gpsolver_tpu_torch/csrc/gram_tile.cu",
        "replaces": "nonlinpdes_gpsolver_tpu/ops/pallas_gram.py:54",
        "launches": launches,
        "max_abs_err": canon_abs,
        "ms": sum(a["ms"] for a in canon_asm),
        "plain_ms": sum(a["plain_ms"] for a in canon_asm),
        "bound_ms": sum(a["bound_ms"] for a in canon_asm),
        "bound_by": max(canon_asm, key=lambda a: a["bound_ms"])["bound_by"],
        "library_ms": None,
        "checked": True,
        "per": "the canonical solve's 2 launches (training Gram, test cross-Gram), summed",
        "large_solve_ms": sum(a["ms"] for a in big_asm),
        "large_solve_plain_ms": sum(a["plain_ms"] for a in big_asm),
        "large_solve_bound_ms": sum(a["bound_ms"] for a in big_asm),
        "large_solve_launches": big_launches,
        "large_solve_max_abs_err": big_abs,
        "workloads": wl_summary,
        "mesh_path": {
            "per": "the mesh path's K1 launches (sampled-row probes, test cross-Gram chunks), summed",
            "mesh_elliptic_launches": mesh_solve["k1_launches"], **{
                f"mesh_elliptic_{k}": v for k, v in mesh_k1_total.items()},
            "mesh_darcy_launches": mesh_darcy["k1_launches"], **{
                f"mesh_darcy_{k}": v for k, v in darcy_k1_total.items()},
            "mesh_vs_dense_launches": mvd_launches[0], **{
                f"mesh_vs_dense_{k}": v for k, v in mvd_k1_total.items()},
            "mesh_ranks_launches": [r["mesh_elliptic"]["k1_launches"] for r in ranks["ranks"]],
            "mesh_nccl_launches": [r["k1_launches"] for r in nccl["ranks"]],
        },
        "checkpoint_launches": {"dense_extension": ck_dense["k1_launches"],
                                "mesh_extension_in_child": ck_mesh["child"]["k1_launches"]},
        "compat_launches": compat["k1_launches"],
    }, {
        "name": "gram_tile_k2",
        "route": "cuda",
        "source": "nonlinpdes_gpsolver_tpu_torch/csrc/gram_tile.cu",
        "replaces": "nonlinpdes_gpsolver_tpu/parallel/fused.py:188, "
                    "nonlinpdes_gpsolver_tpu/parallel/gram.py:109",
        "launches": mesh_solve["k2_launches"],
        "max_abs_err": k2_total["max_abs_err"],
        "ms": k2_total["ms"],
        "plain_ms": k2_total["plain_ms"],
        "bound_ms": k2_total["bound_ms"],
        "bound_by": max(k2_rows, key=lambda a: a["bound_ms"])["bound_by"],
        "library_ms": None,
        "checked": True,
        "per": "mesh_elliptic's superblock windows (one K2 launch each), summed, f32",
        "k2_vs_plain_total": k2["total"],
        "k2_vs_plain_worst_rel_err": k2["worst_rel_err"],
        "mesh_darcy_launches": mesh_darcy["k2_launches"],
        **{f"mesh_darcy_{k}": v for k, v in darcy_k2_total.items()},
        "mesh_vs_dense_launches": mvd_launches[1],
        **{f"mesh_vs_dense_{k}": v for k, v in mvd_k2_total.items()},
        "rank_mapped": {
            "per": "mesh_elliptic's windows on each of 2 ranks sharing the card (one rank-mapped "
                   "K2 launch each), summed per rank, f32; and k2_vs_plain's P = 2 windows",
            "mesh_ranks_launches": [r["mesh_elliptic"]["k2_launches"] for r in ranks["ranks"]],
            **{f"mesh_ranks_{k}": [r["k2_total"][k] for r in ranks["ranks"]]
               for k in ("ms", "plain_ms", "bound_ms", "max_abs_err")},
            **{f"k2_vs_plain_{k}": v for k, v in k2["rank_mapped_total"].items()},
        },
    }, {
        "name": "trsm_rowblock",
        "route": "cuda",
        "source": "nonlinpdes_gpsolver_tpu_torch/csrc/trsm_rowblock.cu",
        "replaces": "torch.linalg.solve_triangular (cuBLAS trsm) at P = 1; counterpart of "
                    "nonlinpdes_gpsolver_tpu/parallel/cholesky.py:368 and :397 (plain JAX)",
        "launches": mesh_darcy["trsm_launches"],
        "launches_per": "darcy_past_wall's warm solve (phase mesh_darcy)",
        "phase_launches": trsm["launches"],
        "max_rel_err": max(r["rel_err"] for r in trsm["cases"]),
        **{key: sum(r[key] for r in trsm["cases"] if r["case"].startswith("darcy"))
           for key in ("ms", "plain_ms", "bound_ms", "library_ms")},
        "checked": True,
        "per": "one CG iteration's four solves at Darcy's shapes (u and phi, forward and "
               "transposed, 61 columns), summed, f32",
        "cases": trsm["cases"],
    }, {
        "name": "normal_matrix",
        "route": "cuda",
        "source": "nonlinpdes_gpsolver_tpu_torch/csrc/normal_matrix.cu",
        "replaces": "the einsum assembly and equilibration of the 'normal' step; counterpart of "
                    "the XLA einsums at nonlinpdes_gpsolver_tpu/solvers/distributed.py:843-844",
        "launches": steps["float32_darcy_normal"]["normal_launches"],
        "launches_per": "mesh_steps' float32 Darcy 'normal' solve (two blocks, eager), its "
                        "counters zeroed before it",
        "assemblies": steps["float32_darcy_normal"]["assemblies"],
        "elliptic_launches": steps["float32_elliptic_normal"]["normal_launches"],
        "phase_launches": normal["launches"],
        "max_rel_err": max(r["rel_err_f64"] for r in normal["cases"]),
        **{key: normal["cases"][0][key] for key in ("ms", "plain_ms", "bound_ms", "bound_by")},
        "library_ms": None,
        "einsum_ms": normal["cases"][0]["einsum_ms"],
        "checked": True,
        "per": "one step's launch at Burgers' shapes (S 4, s 3, N 5,000), f32",
        "cases": normal["cases"],
    }]}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    import sys

    if sys.argv[1:2] == ["--checkpoint-child"]:
        checkpoint_child(*sys.argv[2:5])
    else:
        main()
