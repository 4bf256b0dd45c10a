"""The port on a CUDA card: the Gram kernel against its plain version (one
block, and whole one-launch Gram and cross-Gram matrices), its wrapper's
checks, the canonical solve and the other reference workloads through the
kernel, a Woodbury step against the direct one, the Gauss-Newton loop
recorded and replayed, and one recorded loop shared by new problems of one
structure.

These tests need a card and skip without one (the kernel has no CPU mode).
The file imports nothing of JAX, so on a machine with a card and no JAX it
runs without the repo's conftest:

    python -m pytest --noconftest -q tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

import nonlinpdes_gpsolver_tpu_torch as tpt
from nonlinpdes_gpsolver_tpu_torch.ops import gram_tile
from nonlinpdes_gpsolver_tpu_torch.ops.operators import d, d2, identity, laplacian
from torch_time_limit import time_limit  # noqa: F401  (autouse fixture)

GATE_L2 = 3.402e-3  # BASELINE.md row 1, the bench.py accuracy gate
OPS = {"id": identity, "lap": laplacian, "d0": lambda: d(0), "d11": lambda: d2(1, 1)}
KERNELS = {
    "gaussian": tpt.SquaredExponential.gaussian(0.2),
    "aniso_len": tpt.SquaredExponential.anisotropic([0.3, 0.05]),
}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the Gram tile kernel has no CPU mode")
    return torch.device("cuda")


def _points(n, m, dtype, device, seed=3):
    rng = np.random.default_rng(seed)
    return (
        torch.as_tensor(rng.uniform(0, 1, (n, 2)), dtype=dtype, device=device),
        torch.as_tensor(rng.uniform(0, 1, (m, 2)), dtype=dtype, device=device),
    )


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,limit", [(torch.float32, 1e-5), (torch.float64, 1e-12)])
@pytest.mark.parametrize("kname", list(KERNELS))
@pytest.mark.parametrize("ox,oy", [("id", "id"), ("lap", "id"), ("lap", "lap"), ("d0", "d0"), ("d11", "id")])
def test_kernel_matches_plain(cuda, dtype, limit, kname, ox, oy):
    """max|kernel - plain| / max|block|: 1e-5 in f32 (FMA contraction and
    summation order differ from the plain version), 1e-12 in f64."""
    X, Y = _points(300, 171, dtype, cuda)
    k = KERNELS[kname]
    fn = gram_tile.gram_tile_pair_fn(k, OPS[ox](), OPS[oy]())
    before = gram_tile.LAUNCHES
    got = fn(X, Y)
    torch.cuda.synchronize()
    assert gram_tile.LAUNCHES == before + 1
    ref = k.pair_fn(OPS[ox](), OPS[oy]())(X, Y)
    assert float((got - ref).abs().max() / ref.abs().max()) <= limit


@pytest.mark.cuda
def test_kernel_writes_into_strided_slot(cuda):
    """A ragged block lands in a slot of a larger matrix through its row
    stride and leaves every other entry as it was."""
    X, Y = _points(33, 17, torch.float64, cuda, seed=4)
    k = KERNELS["aniso_len"]
    fn = gram_tile.gram_tile_pair_fn(k, laplacian(), d(1))
    big = torch.full((40, 30), 7.0, dtype=torch.float64, device=cuda)
    fn(X, Y, out=big[5:38, 9:26])
    ref = k.pair_fn(laplacian(), d(1))(X, Y)
    assert float((big[5:38, 9:26] - ref).abs().max() / ref.abs().max()) <= 1e-12
    big[5:38, 9:26] = 7.0
    assert bool((big == 7.0).all())


@pytest.mark.cuda
def test_wrapper_rejects_what_the_kernel_cannot_take(cuda):
    fn = gram_tile.gram_tile_pair_fn(KERNELS["gaussian"], identity(), identity())
    X = torch.rand((8, 2), device=cuda)
    with pytest.raises(TypeError):
        fn(X.to(torch.bfloat16), X.to(torch.bfloat16))
    with pytest.raises(ValueError, match="contiguous"):
        fn(torch.rand((2, 8), device=cuda).T, X)
    with pytest.raises(ValueError):
        fn(torch.rand((8, 3), device=cuda), X)
    with pytest.raises(ValueError, match="stride"):
        fn(X, X, out=torch.empty((8, 16), device=cuda)[:, ::2])


# Ragged point sets (no size a tile multiple) and operators of every parity.
RAGGED = {"domain": 65, "boundary": 33, "edge": 7}
RAGGED_OBS = (
    ("domain", laplacian), ("domain", identity), ("boundary", lambda: d(0)),
    ("boundary", identity), ("edge", lambda: d2(1, 1)),
)


def _ragged(dtype, device, seed=5):
    rng = np.random.default_rng(seed)
    pts = {
        k: torch.as_tensor(rng.uniform(0, 1, (n, 2)), dtype=dtype, device=device)
        for k, n in RAGGED.items()
    }
    obs = tuple(tpt.ops.Observable(k, op()) for k, op in RAGGED_OBS)
    return pts, obs


def _assert_blocks_close(plan, got, ref, limit):
    """Every block (and its mirror) within ``limit`` of that block's scale."""
    for b in plan.blocks:
        slots = [(slice(b.row_off, b.row_off + b.n), slice(b.col_off, b.col_off + b.m))]
        if b.mirror:
            slots.append(slots[0][::-1])
        for rs, cs in slots:
            scale = float(ref[rs, cs].abs().max())
            assert float((got[rs, cs] - ref[rs, cs]).abs().max()) <= limit * scale, (b, rs, cs)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,limit", [(torch.float32, 1e-5), (torch.float64, 1e-12)])
@pytest.mark.parametrize("kname", list(KERNELS))
def test_one_launch_gram_matches_plain(cuda, dtype, limit, kname):
    """Theta of five observables on three ragged point sets in one launch:
    each block within the limit of its scale, and Theta exactly symmetric."""
    pts, obs = _ragged(dtype, cuda)
    k = KERNELS[kname]
    before = gram_tile.LAUNCHES
    theta = tpt.ops.gram_matrix(k, obs, pts)
    torch.cuda.synchronize()
    assert gram_tile.LAUNCHES == before + 1
    plan = gram_tile.gram_plan(k, obs, tpt.ops.observable_sizes(obs, pts))
    assert len(plan.blocks) == 15 and sum(b.symmetric for b in plan.blocks) == 5
    ref = torch.zeros_like(theta)
    plan._plain([pts[s] for s in plan.set_keys], ref)
    _assert_blocks_close(plan, theta, ref, limit)
    assert bool(torch.equal(theta, theta.T))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,limit", [(torch.float32, 1e-5), (torch.float64, 1e-12)])
@pytest.mark.parametrize("row_op", [identity, laplacian])
def test_one_launch_cross_gram_matches_plain(cuda, dtype, limit, row_op):
    pts, obs = _ragged(dtype, cuda)
    k = KERNELS["aniso_len"]
    X = _points(97, 1, dtype, cuda, seed=6)[0]
    before = gram_tile.LAUNCHES
    got = tpt.ops.cross_gram(k, row_op(), X, obs, pts)
    torch.cuda.synchronize()
    assert gram_tile.LAUNCHES == before + 1
    assert got.shape == (97, 65 + 65 + 33 + 33 + 7)
    plan = gram_tile.cross_plan(k, row_op(), 97, obs, tpt.ops.observable_sizes(obs, pts))
    ref = torch.zeros_like(got)
    plan._plain([X, *(pts[s] for s in plan.set_keys)], ref)
    _assert_blocks_close(plan, got, ref, limit)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_one_launch_gram_into_strided_slot(cuda, dtype):
    """A whole Theta lands in a slot of a larger buffer through its row
    stride, equal to the freshly allocated one, and nothing else changes."""
    pts, obs = _ragged(dtype, cuda, seed=7)
    k = KERNELS["gaussian"]
    plan = gram_tile.gram_plan(k, obs, tpt.ops.observable_sizes(obs, pts))
    sets = [pts[s] for s in plan.set_keys]
    n = plan.shape[0]
    big = torch.full((n + 9, n + 21), 7.0, dtype=dtype, device=cuda)
    plan.run(sets, out=big[4 : 4 + n, 13 : 13 + n])
    assert bool(torch.equal(big[4 : 4 + n, 13 : 13 + n], plan.run(sets)))
    big[4 : 4 + n, 13 : 13 + n] = 7.0
    assert bool((big == 7.0).all())


@pytest.mark.cuda
def test_wrapper_rejects_plans_beyond_the_limits(cuda):
    """Pairs and plans the kernel cannot take raise before any launch."""
    X = torch.rand((8, 2), device=cuda)
    before = gram_tile.LAUNCHES
    deep = tpt.ops.LinearOp(2, ((1.0, (5, 0)),))  # degree 10 in one dimension
    with pytest.raises(ValueError, match="order"):
        gram_tile.gram_tile_pair_fn(KERNELS["gaussian"], deep, deep)(X, X)
    k4 = tpt.SquaredExponential.gaussian(0.2, dim=4)
    with pytest.raises(ValueError, match="dim"):
        gram_tile.gram_tile_pair_fn(k4, identity(4), identity(4))(
            torch.rand((8, 4), device=cuda), torch.rand((8, 4), device=cuda)
        )
    many = tuple(tpt.ops.Observable("p", d2(i % 2, j % 2)) for i in range(3) for j in range(3))
    with pytest.raises(ValueError, match="blocks"):
        tpt.ops.gram_matrix(KERNELS["gaussian"], many, {"p": X})
    assert gram_tile.LAUNCHES == before


def _u_truth(x):
    return torch.sin(torch.pi * x[0]) * torch.sin(torch.pi * x[1]) + 2 * torch.sin(
        4 * torch.pi * x[0]
    ) * torch.sin(4 * torch.pi * x[1])


@pytest.mark.cuda
def test_canonical_factor_takes_no_rung(cuda):
    """The f64 factorization of the f32 equilibrated Gram matrix accepts the
    canonical problem at the starting nugget scale; the f32 one took a rung."""
    prob = tpt.interop.problem_from_numpy(**tpt.interop.load_canonical_inputs(), device=cuda)
    fp = tpt.GPSolver(prob, nugget=1e-5).fp
    assert fp.rungs == {"u": 0}
    assert fp.factors["u"].dtype == torch.float32


@pytest.mark.cuda
@pytest.mark.parametrize("op", [identity, laplacian])
def test_posterior_variance_on_card(cuda, op):
    """The variance stays on the card: its prior term is one K1 launch on
    X_test's device. Far from every training point the variance equals the
    prior (op (x) op) kappa(x, x); elsewhere it lies in [0, prior]."""
    prob = tpt.interop.problem_from_numpy(**tpt.interop.load_canonical_inputs(), device=cuda)
    post = tpt.GPSolver(prob, nugget=1e-5).solve(max_iter=4).posterior
    k = prob.blocks[0].kernel
    prior = float(k.pair_fn(op(), op())(*(torch.zeros((1, 2), dtype=torch.float64),) * 2))
    Xt = torch.cat([
        tpt.utils.test_grid(30, 30, device=cuda),
        torch.tensor([[2.5, 2.5], [-1.5, -1.5]], device=cuda),
    ])
    before = gram_tile.LAUNCHES
    var = post.variance(Xt, op=op())
    torch.cuda.synchronize()
    assert gram_tile.LAUNCHES - before == 2  # the one-launch cross-Gram + the prior
    assert var.device.type == "cuda" and var.dtype == torch.float32 and var.shape == (902,)
    assert bool(torch.isfinite(var).all())
    assert float(var.max()) <= prior * (1 + 1e-6)
    np.testing.assert_allclose(var[-2:].cpu().numpy(), prior, rtol=1e-6)
    assert bool(torch.equal(post.std(Xt, op=op()), torch.sqrt(var)))


@pytest.mark.cuda
def test_canonical_solve_passes_gate_with_two_launches(cuda):
    u_truth = _u_truth
    prob = tpt.interop.problem_from_numpy(**tpt.interop.load_canonical_inputs(), device=cuda)
    assert prob.dtype == torch.float32
    before = gram_tile.LAUNCHES
    res = tpt.GPSolver(prob, nugget=1e-5).solve(max_iter=4)
    Xt = tpt.utils.test_grid(60, 60, device=cuda)
    pred = res.posterior.extend(Xt)
    torch.cuda.synchronize()
    assert gram_tile.LAUNCHES - before == 2  # the training Gram and the test cross-Gram
    err = tpt.GPSolver.errors(pred, torch.func.vmap(u_truth)(Xt))
    assert err.l2 <= GATE_L2, err


@pytest.mark.cuda
@pytest.mark.parametrize("name,launches", [("burgers", 2), ("eikonal", 2), ("darcy", 4)])
def test_workload_passes_gate_with_its_launches(cuda, name, launches):
    """The JAX package's draw of each reference workload, f32 on the card:
    one K1 launch per training Gram and per test cross-Gram (Darcy: two of
    each), and the workload's gate."""
    w = tpt.workloads.WORKLOADS[name](device=cuda)
    assert w.problem.dtype == torch.float32
    before = gram_tile.LAUNCHES
    res = w.solve()
    metrics = w.metrics(res)
    torch.cuda.synchronize()
    assert gram_tile.LAUNCHES - before == launches
    assert not w.failures(metrics), metrics


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["burgers", "darcy"])
def test_workload_training_plans_match_plain(cuda, name):
    """Each training Gram of the workload in one f32 launch, every block
    within 1e-5 of its scale of the plain version, exactly symmetric."""
    w = tpt.workloads.WORKLOADS[name](device=cuda)
    pts = w.problem.points
    for b in w.problem.blocks:
        plan = gram_tile.gram_plan(b.kernel, b.observables, tpt.ops.observable_sizes(b.observables, pts))
        sets = [pts[s] for s in plan.set_keys]
        got = plan.run(sets)
        ref = torch.zeros_like(got)
        plan._plain(sets, ref)
        torch.cuda.synchronize()
        _assert_blocks_close(plan, got, ref, 1e-5)
        assert bool(torch.equal(got, got.T))


@pytest.mark.cuda
def test_small_darcy_woodbury_step_matches_direct(cuda):
    """f64: one 'woodbury' step on the JAX package's small Darcy fixture
    (48/16, sigma 0.4, nugget 1e-4, trsm; points from the port's sampler)
    matches the 'direct' step to 1e-5 of z's scale."""
    gen = torch.Generator(device=cuda).manual_seed(0)
    Xd, Xb = tpt.utils.sample_random(gen, 48, 16, dtype=torch.float64)
    k = tpt.SquaredExponential.gaussian(0.4)
    obs = torch.linspace(0.0, 0.01, 12, dtype=torch.float64, device=cuda)
    prob = tpt.models.darcy_flow(k, k, Xd, Xb, obs, lambda x: torch.ones_like(x[0]),
                                 noise_level=1e-2, seed=3)
    fp = tpt.factorize(prob, 1e-4, solve_mode="trsm")
    direct = tpt.gn_solve(fp, max_iter=1, step_solver="direct")
    wood = tpt.gn_solve(fp, max_iter=1, step_solver="woodbury", cg_tol=1e-9, cg_maxiter=2000)
    assert float((wood.z - direct.z).abs().max() / direct.z.abs().max()) < 1e-5
    np.testing.assert_allclose(wood.losses.cpu().numpy(), direct.losses.cpu().numpy(), rtol=1e-5)
    assert 0 < int(wood.cg_iters[0]) < 2000


def _check_k2_launch(plan, sets, d_r, d_c, big, slot, limit):
    """One K2 launch of ``plan`` into ``slot``, a view of ``big`` (all 7),
    against its plain version: every block within ``limit`` of its scale,
    the fill blocks exact, the unit diagonal exactly 1 where the rows' window
    rows meet it, nothing written outside the slot (``slot`` is refilled)."""
    before = (gram_tile.LAUNCHES, gram_tile.K2_LAUNCHES)
    plan.run_equilibrated(sets, d_r, d_c, out=slot)
    torch.cuda.synchronize()
    assert (gram_tile.LAUNCHES, gram_tile.K2_LAUNCHES) == (before[0], before[1] + 1)
    ref = torch.empty_like(slot)
    plan._plain_equilibrated(sets, d_r, d_c, ref)
    _assert_blocks_close(plan, slot, ref, limit)
    w = plan.window_rows(slot.device)
    on = w < plan.shape[1]
    assert bool((slot[torch.nonzero(on)[:, 0], w[on]] == 1.0).all())
    for b in plan.blocks:
        if b.fill:
            rs, cs = slice(b.row_off, b.row_off + b.n), slice(b.col_off, b.col_off + b.m)
            assert bool(torch.equal(slot[rs, cs], ref[rs, cs]))
    slot.fill_(7.0)
    assert bool((big == 7.0).all())


def _darcy_u(n_dom, device, dtype):
    gen = torch.Generator(device=device).manual_seed(0)
    Xd, Xb = tpt.utils.sample_random(gen, n_dom, n_dom // 4, dtype=dtype)
    k = tpt.SquaredExponential.gaussian(0.2)
    prob = tpt.models.darcy_flow(k, k, Xd, Xb, torch.zeros(8, dtype=dtype, device=device), None)
    return prob.block("u"), prob.points


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,limit", [(torch.float32, 1e-5), (torch.float64, 1e-12)])
@pytest.mark.parametrize("n_dom,block,sup", [(300, 512, 2048), (700, 128, 512)])
def test_k2_windows_match_plain(cuda, dtype, limit, n_dom, block, sup):
    """Every superblock window of the Darcy u layout (5 observables on 2
    point sets) in one K2 launch each: every block within ``limit`` of its
    scale of the plain version, the diagonal exactly 1, the fill blocks
    exact, nothing written outside the slot."""
    from nonlinpdes_gpsolver_tpu_torch.parallel import fused, gram

    blk, pts = _darcy_u(n_dom, cuda, dtype)
    sizes = tpt.ops.observable_sizes(blk.observables, pts)
    n = sum(sizes)
    n_pad = -(-n // block) * block
    d = torch.linspace(0.5, 1.5, n_pad, dtype=dtype, device=cuda)
    for kb0, F in fused._superblocks(n_pad // block, sup // block):
        c0, c1 = kb0 * block, (kb0 + F) * block
        plan = fused.window_plan(blk.kernel, blk.observables, sizes, c0, c1, n_pad)
        sets = gram.window_sets(plan, pts)
        h, S = plan.shape
        big = torch.full((h + 5, S + 9), 7.0, dtype=dtype, device=cuda)
        _check_k2_launch(plan, sets, d[c0:], d[c0:c1], big, big[2 : 2 + h, 4 : 4 + S], limit)


@pytest.mark.cuda
def test_small_mesh_solve_on_card(cuda):
    """A 3,000-row elliptic problem on the mesh path in f32 (several
    superblocks): K2 launches one per superblock, the posterior is the mesh
    path's, and the test L2 passes the 3.402e-3 gate."""
    w = tpt.workloads.mesh_elliptic(device=cuda, n_domain=1300, n_boundary=400)
    before = gram_tile.K2_LAUNCHES
    res = tpt.GPSolver(w.problem, nugget=1e-5, mesh=tpt.parallel.make_mesh(1, device=cuda),
                       mesh_block=256).solve(max_iter=4)
    metrics = w.metrics(res)
    torch.cuda.synchronize()
    fp = res.posterior.fp
    assert isinstance(res.posterior, tpt.solvers.DistributedPosterior)
    assert gram_tile.K2_LAUNCHES - before == fp.stats["u"]["superblocks"] >= 2
    assert not w.failures(metrics), metrics


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,limit", [(torch.float32, 1e-5), (torch.float64, 1e-12)])
@pytest.mark.parametrize("ranks,rank", [(2, 0), (2, 1), (4, 3)])
def test_k2_rank_mapped_windows_match_plain(cuda, dtype, limit, ranks, rank):
    """K2 on a rank's block-cyclic rows: every window of the Darcy u layout
    at N_d 700 (128-row blocks, 512-wide superblocks) on rank ``rank`` of
    ``ranks``, one launch each, against the rank-mapped plain version:
    every block within ``limit``, the unit diagonal exactly 1 where the
    rank's rows meet it, the fill blocks exact, nothing outside the slot."""
    from nonlinpdes_gpsolver_tpu_torch.parallel import fused, gram, pad_to_blocks

    blk, pts = _darcy_u(700, cuda, dtype)
    sizes = tpt.ops.observable_sizes(blk.observables, pts)
    block = 128
    n_pad = pad_to_blocks(sum(sizes), block, ranks)
    d = torch.linspace(0.5, 1.5, n_pad, dtype=dtype, device=cuda)
    launched = 0
    for kb0, F in fused._superblocks(n_pad // block, 512 // block):
        c0, c1 = kb0 * block, (kb0 + F) * block
        plan = fused.window_plan(blk.kernel, blk.observables, sizes, c0, c1, n_pad, ranks, rank,
                                 block)
        h, S = plan.shape
        if h == 0:
            continue
        sets = gram.window_sets(plan, pts)
        big = torch.full((h + 5, S + 9), 7.0, dtype=dtype, device=cuda)
        _check_k2_launch(plan, sets, d[c0:], d[c0:c1], big, big[2 : 2 + h, 4 : 4 + S], limit)
        launched += 1
    assert launched >= 2


K2_STORE_CASES = {
    # name: (layout, rows a block, P ranks, rank, window)
    "tma": ("elliptic", 128, 1, 0, (0, 256)),
    "ragged": ("darcy", 128, 1, 0, (0, 512)),
    "column": ("darcy", 512, 1, 0, (0, 1536)),
    "base": ("darcy", 128, 1, 0, (0, 512)),
    "ldo": ("darcy", 128, 1, 0, (0, 512)),
    "rank 3 of 4": ("darcy", 128, 4, 3, (512, 1024)),
}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,limit", [(torch.float32, 1e-5), (torch.float64, 1e-12)])
@pytest.mark.parametrize("case", list(K2_STORE_CASES))
def test_k2_store_paths(cuda, dtype, limit, case):
    """Each store path of K2 in one launch, held to the plain version as
    :func:`_check_k2_launch` holds it (the paths from ``GramPlan.k2_tiles``):
    ``tma``, the elliptic layout at 256 + 128 points (segments of 256, 256
    and 128 rows), every tile inside its block and stored by TMA;
    ``ragged``, the Darcy u layout at N_d 300 (segments of 300 and 75 rows,
    a fill block), tiles cut by a segment end or a fill block stored by the
    threads beside full ones by TMA; ``column``, its one window at 512-row
    blocks, whose fill columns start at column 1,275 (no 16-byte multiple):
    full tiles there by the threads; ``base`` and ``ldo``, the ``ragged``
    window in a view whose base, or whose row stride, is no 16-byte
    multiple: every tile by the threads; ``rank 3 of 4``, a rank-mapped
    window of the Darcy layout (1,536 padded rows) whose last block lies in
    the padding."""
    from nonlinpdes_gpsolver_tpu_torch.parallel import fused, gram, pad_to_blocks

    layout, block, ranks, rank, (c0, c1) = K2_STORE_CASES[case]
    if layout == "darcy":
        blk, pts = _darcy_u(300, cuda, dtype)
    else:
        gen = torch.Generator(device=cuda).manual_seed(0)
        Xd, Xb = tpt.utils.sample_random(gen, 256, 128, dtype=dtype)
        prob = tpt.models.nonlinear_elliptic(tpt.SquaredExponential.gaussian(0.2), Xd, Xb, None,
                                             None)
        blk, pts = prob.block("u"), prob.points
    sizes = tpt.ops.observable_sizes(blk.observables, pts)
    n_pad = pad_to_blocks(sum(sizes), block, ranks)
    plan = fused.window_plan(blk.kernel, blk.observables, sizes, c0, c1, n_pad, ranks, rank,
                             block)
    h, S = plan.shape
    vec = 128 // torch.finfo(dtype).bits  # entries in 16 bytes
    ldo, col = S + 2 * vec + (case == "ldo"), vec + (case == "base")
    big = torch.full((h + 4, ldo), 7.0, dtype=dtype, device=cuda)
    slot = big[2 : 2 + h, col : col + S]
    aligned = slot.data_ptr() % 16 == 0 and ldo * slot.element_size() % 16 == 0
    assert aligned == (case not in ("base", "ldo"))
    tiles = plan.k2_tiles(slot)
    by_tma = sum(t[3] for t in tiles)
    expect = {"tma": by_tma == len(tiles), "base": by_tma == 0, "ldo": by_tma == 0}
    assert expect.get(case, 0 < by_tma < len(tiles)), (case, by_tma, len(tiles))
    full_by_threads = [t for t in tiles if not t[3] and t[0].stop - t[0].start == gram_tile.TILE
                       and t[1].stop - t[1].start == gram_tile.TILE]
    assert bool(full_by_threads) == (case in ("column", "base", "ldo")), case
    assert 0 < sum(t[2] for t in tiles) < len(tiles)  # tiles with and without the diagonal
    assert any(b.fill for b in plan.blocks) == (case != "tma")
    d = torch.linspace(0.5, 1.5, n_pad, dtype=dtype, device=cuda)
    _check_k2_launch(plan, gram.window_sets(plan, pts), d[c0:], d[c0:c1], big, slot, limit)


def _two_rank_solve(rank, world, port, out_dir):
    """One of two ranks sharing card 0 over gloo: the 3,000-row mesh solve."""
    import os

    os.environ.update(RANK=str(rank), LOCAL_RANK=str(rank), WORLD_SIZE=str(world),
                      MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
    import torch.distributed as dist

    from nonlinpdes_gpsolver_tpu_torch.parallel import initialize_distributed, make_mesh

    assert initialize_distributed(backend="gloo")
    try:
        mesh = make_mesh(world, device="cuda:0")
        w = tpt.workloads.mesh_elliptic(device=mesh.device, n_domain=1300, n_boundary=400)
        before = gram_tile.K2_LAUNCHES
        res = tpt.GPSolver(w.problem, nugget=1e-5, mesh=mesh, mesh_block=256).solve(max_iter=4)
        metrics = w.metrics(res)
        torch.cuda.synchronize()
        torch.save({"z": res.z.cpu(), "l2": metrics["test_l2"],
                    "failures": w.failures(metrics),
                    "k2": gram_tile.K2_LAUNCHES - before,
                    "superblocks": res.posterior.fp.stats["u"]["superblocks"]},
                   os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


@pytest.mark.cuda
def test_two_ranks_share_the_card_over_gloo(cuda, tmp_path):
    """Two spawned ranks on card 0 over gloo (host-staged collectives) run
    the 3,000-row mesh solve: each rank's K2 launches one per superblock,
    the same z on both ranks, within 1e-4 of its scale of the one-device
    solve (f32: the triangular solves round differently), and the gate."""
    import socket

    import torch.multiprocessing as mp

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    mp.spawn(_two_rank_solve, args=(2, port, str(tmp_path)), nprocs=2, join=True)
    got = [torch.load(tmp_path / f"rank{r}.pt") for r in range(2)]
    w = tpt.workloads.mesh_elliptic(device=cuda, n_domain=1300, n_boundary=400)
    one = tpt.GPSolver(w.problem, nugget=1e-5, mesh=tpt.parallel.make_mesh(1, device=cuda),
                       mesh_block=256).solve(max_iter=4)
    z1 = one.z.cpu()
    assert torch.equal(got[0]["z"], got[1]["z"])
    assert float((got[0]["z"] - z1).abs().max() / z1.abs().max()) <= 1e-4
    for g in got:
        assert not g["failures"], g["l2"]
        assert g["k2"] == g["superblocks"] >= 2


@pytest.mark.cuda
def test_checkpoint_f64_file_resumes_on_card(cuda, tmp_path):
    """A checkpoint in the JAX package's format saved in f64 (the canonical
    problem solved on the CPU, nugget 1e-5, 4 GN steps) loads into the
    problem on the card in f32: the factor and z are the f64 arrays cast,
    one more GN step and the extension run on the card (one K1 launch, the
    cross-Gram), and the test L2 passes the gate."""
    inp = tpt.interop.load_canonical_inputs()
    cpu = tpt.interop.problem_from_numpy(**inp, device="cpu")
    fp64 = tpt.factorize(cpu, 1e-5)
    st64 = tpt.gn_solve(fp64, max_iter=4)
    tpt.utils.save_solver_state(tmp_path / "f64.npz", fp64, st64)
    prob = tpt.interop.problem_from_numpy(**inp, device=cuda)
    fp, st = tpt.utils.load_solver_state(tmp_path / "f64.npz", prob)
    assert fp.factors["u"].dtype == torch.float32 and fp.factors["u"].is_cuda
    assert torch.equal(fp.factors["u"].cpu(), fp64.factors["u"].float())
    assert torch.equal(st.z.cpu(), st64.z.float()) and st.cg_iters.tolist() == [0] * 4
    resumed = tpt.gn_solve(fp, z0=st.z, max_iter=1)
    assert bool(resumed.converged_finite)
    Xt = tpt.utils.test_grid(60, 60, device=cuda)
    before = gram_tile.LAUNCHES
    pred = tpt.Posterior(fp, resumed.z).extend(Xt)
    torch.cuda.synchronize()
    assert gram_tile.LAUNCHES - before == 1
    err = tpt.GPSolver.errors(pred, torch.func.vmap(tpt.workloads.u_elliptic)(Xt))
    assert err.l2 <= GATE_L2, err


@pytest.mark.cuda
def test_solver_gp_on_card(cuda):
    """The reference-API facade with no ``cfg.device``: the card, f32, the
    canonical draw's points, 4 GN steps at nugget 1e-5, the 60x60 test grid
    under the gate with two K1 launches."""
    import argparse

    from nonlinpdes_gpsolver_tpu_torch.compat import solver_GP

    inp = tpt.interop.load_canonical_inputs()
    cfg = argparse.Namespace(kernel="Gaussian", kernel_parameter=0.2, nugget=1e-5, GNsteps=4,
                             initial_sol="rdm", randomseed=1, print_hist=False)
    u = tpt.workloads.u_elliptic
    f = tpt.workloads.elliptic_rhs()
    solver = solver_GP(cfg, PDE_type="Nonlinear_elliptic")
    solver.set_equation(bdy=u, rhs=f)
    solver.get_sample(inp["X_domain"], inp["X_boundary"])
    before = gram_tile.LAUNCHES
    solver.solve(method="elimination")
    Xt = tpt.utils.test_grid(60, 60, device=cuda)
    pred = solver.test(Xt)
    torch.cuda.synchronize()
    assert gram_tile.LAUNCHES - before == 2
    assert pred.is_cuda and pred.dtype == torch.float32
    stats = solver.get_test_error(torch.func.vmap(u)(Xt), print_option=False)
    assert stats.l2 <= GATE_L2, stats


@pytest.mark.cuda
@pytest.mark.parametrize("step", ["structured", "direct", "cg"])
def test_gn_loop_replays_its_eager_steps(cuda, step):
    """The Gauss-Newton loop recorded as CUDA graphs and replayed gives the
    eager steps' z and losses bitwise (canonical problem, f32, 4 steps), a
    warm solve records nothing, and the replay makes no host read
    (``'structured'``, ``'direct'``) or one a CG iteration (``'cg'``)."""
    from nonlinpdes_gpsolver_tpu_torch.ops import graphs

    prob = tpt.interop.problem_from_numpy(**tpt.interop.load_canonical_inputs(), device=cuda)
    fp = tpt.factorize(prob, 1e-5)
    kw = dict(max_iter=4, step_solver=step, cg_maxiter=50)
    with graphs.uncaptured():
        eager = tpt.gn_solve(fp, **kw)
    for _ in range(2):
        tpt.gn_solve(fp, **kw)
    graphs.reset_counts()
    replayed = tpt.gn_solve(fp, **kw)
    torch.cuda.synchronize()
    assert graphs.CAPTURES == 0 and graphs.REPLAYS > 0
    assert torch.equal(replayed.z, eager.z) and torch.equal(replayed.losses, eager.losses)
    iters = replayed.cg_iters.tolist()
    if step == "cg":
        assert graphs.HOST_READS <= sum(iters) + len(iters) + 1
    else:
        assert graphs.HOST_READS == 0 and iters == [0] * 4


def _sampled_canonical(seed, device, n_domain=900):
    """The canonical configuration (sigma 0.2, 900/124 points) on a fresh
    draw of the port's sampler."""
    Xd, Xb = tpt.utils.sample_random(torch.Generator(device=device).manual_seed(seed), n_domain,
                                     124)
    return tpt.models.nonlinear_elliptic(tpt.SquaredExponential.gaussian(0.2), Xd, Xb,
                                         tpt.workloads.elliptic_rhs(), tpt.workloads.u_elliptic,
                                         seed=seed)


@pytest.mark.cuda
def test_new_problems_of_one_structure_share_one_loop(cuda):
    """Three new problems of one structure, each on a new ``GPSolver`` (the
    last one gone): the first makes the entry and runs its exact loop
    eagerly, the second factors into its storage and records the loop, the
    third replays it with no capture, bitwise its eager solve; its loop
    replayed again under ``set_sync_debug_mode("error")``. A released
    entry keeps its factor and data bytes and its graph pool until a
    factorization of another layout frees them."""
    from nonlinpdes_gpsolver_tpu_torch.ops import graphs
    from nonlinpdes_gpsolver_tpu_torch.solvers import _reuse

    tpt.clear_graph_cache()
    seen = []
    for k in range(3):
        graphs.reset_counts()
        solver = tpt.GPSolver(_sampled_canonical(k, cuda), nugget=1e-5)
        binds = (graphs.ENTRIES, graphs.REBINDS, graphs.UNSHARED)
        res = solver.solve(max_iter=4)
        torch.cuda.synchronize()
        seen.append((binds, graphs.CAPTURES, graphs.REPLAYS))
        assert bool(res.state.converged_finite)
        if k == 2:
            torch.cuda.set_sync_debug_mode("error")
            try:
                again = tpt.gn_solve(solver.fp, max_iter=4)
            finally:
                torch.cuda.set_sync_debug_mode(0)
            with graphs.uncaptured():
                eager = solver.solve(max_iter=4)
            assert torch.equal(res.z, eager.z) and torch.equal(res.state.losses, eager.state.losses)
            assert torch.equal(again.z, res.z)
            del again, eager
        del solver, res
    assert seen == [((1, 0, 0), 0, 0), ((0, 1, 0), 1, 4), ((0, 1, 0), 0, 4)]
    n, data = 2 * 900 + 124, 900 + 124  # Gram rows [lap u, u] at 900 points, u at 124
    (entry,) = _reuse.entries()
    pool = _reuse._pool_bytes([entry.pool])[tuple(entry.pool)]
    assert pool > 0 and graphs.RETAINED_BYTES == 4 * (2 * n * n + n + data) + pool
    del entry
    other = tpt.GPSolver(_sampled_canonical(3, cuda, n_domain=901), nugget=1e-5)
    assert graphs.RETAINED_BYTES == 0 and graphs.ENTRIES == 1
    del other
    n, data = n + 2, data + 1
    assert graphs.RETAINED_BYTES == 4 * (2 * n * n + n + data)
    tpt.clear_graph_cache()
    assert graphs.RETAINED_BYTES == 0


@pytest.mark.cuda
def test_held_loop_replays_from_its_fifth_run(cuda):
    """Six new problems of one structure, each result kept until the next
    solve returns: two entries alternate, each eager at its first use,
    recorded at its second and replayed from its third, so that runs 5 and
    6 record nothing; the last run bitwise a solve that shares nothing with
    any entry."""
    from nonlinpdes_gpsolver_tpu_torch.ops import graphs
    from nonlinpdes_gpsolver_tpu_torch.solvers import _reuse

    tpt.clear_graph_cache()
    seen, res = [], None
    for k in range(6):
        graphs.reset_counts()
        prob = _sampled_canonical(10 + k, cuda)
        res = tpt.GPSolver(prob, nugget=1e-5).solve(max_iter=4)
        torch.cuda.synchronize()
        seen.append(((graphs.ENTRIES, graphs.REBINDS, graphs.UNSHARED), graphs.CAPTURES))
        assert bool(res.state.converged_finite)
    assert seen == [((1, 0, 0), 0), ((1, 0, 0), 0), ((0, 1, 0), 1), ((0, 1, 0), 1),
                    ((0, 1, 0), 0), ((0, 1, 0), 0)]
    with graphs.uncaptured(), _reuse._unshared():
        ref = tpt.GPSolver(prob, nugget=1e-5).solve(max_iter=4)
    assert torch.equal(res.z, ref.z) and torch.equal(res.state.losses, ref.state.losses)
    del res, ref
    tpt.clear_graph_cache()


@pytest.mark.cuda
def test_sweep_replays_from_its_fifth_run(cuda):
    """Six new problems of one structure, every result kept: two entries,
    then four guests of the guest entry, which runs eagerly at its first
    use, records at its second and replays from its third, so that runs 5
    and 6 record nothing; each guest's factors copied in once; each run
    bitwise a solve that shares nothing with any entry."""
    from nonlinpdes_gpsolver_tpu_torch.ops import graphs
    from nonlinpdes_gpsolver_tpu_torch.solvers import _reuse

    tpt.clear_graph_cache()
    seen, kept = [], []
    for k in range(6):
        graphs.reset_counts()
        prob = _sampled_canonical(20 + k, cuda)
        res = tpt.GPSolver(prob, nugget=1e-5).solve(max_iter=4)
        torch.cuda.synchronize()
        seen.append(((graphs.ENTRIES, graphs.GUESTS, graphs.GUEST_LOADS), graphs.CAPTURES))
        assert bool(res.state.converged_finite)
        kept.append((prob, res))
    assert seen == [((1, 0, 0), 0), ((1, 0, 0), 0), ((0, 1, 1), 0), ((0, 1, 1), 1),
                    ((0, 1, 1), 0), ((0, 1, 1), 0)]
    for prob, res in kept:
        with graphs.uncaptured(), _reuse._unshared():
            ref = tpt.GPSolver(prob, nugget=1e-5).solve(max_iter=4)
        assert torch.equal(res.z, ref.z) and torch.equal(res.state.losses, ref.state.losses)
    del kept, res, ref
    tpt.clear_graph_cache()


@pytest.mark.cuda
def test_gpsolver_defers_on_card(cuda):
    """On the card ``GPSolver`` defers its quality verdict and ``solve``
    settles it: the canonical problem's verdict passes in one round."""
    prob = tpt.interop.problem_from_numpy(**tpt.interop.load_canonical_inputs(), device=cuda)
    solver = tpt.GPSolver(prob, nugget=1e-5)
    assert torch.is_tensor(solver.fp.quality["u"]) and solver.fp.pending_scales
    solver.solve(max_iter=4)
    assert not solver.fp.pending_scales and solver.fp.quality["u"] < 1e-2
    assert solver.fp.rungs == {"u": 0}


def _nccl_group_of_one(rank, world, port, out_dir):
    """A group of one rank over NCCL on card 0: the 3,000-row mesh problem's
    ``'cg'`` loop, solved twice on one factorization (the second replays)."""
    import os

    os.environ.update(RANK=str(rank), LOCAL_RANK=str(rank), WORLD_SIZE=str(world),
                      MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
    import torch.distributed as dist

    from nonlinpdes_gpsolver_tpu_torch.ops import graphs
    from nonlinpdes_gpsolver_tpu_torch.parallel import comm, initialize_distributed, make_mesh

    assert initialize_distributed(backend="nccl")
    try:
        got = _mesh_cg_twice(make_mesh(1, device="cuda:0"))
        torch.save({**got, "collectives": comm.COLLECTIVES, "captures": graphs.CAPTURES,
                    "replays": graphs.REPLAYS, "agreements": comm.AGREEMENTS},
                   os.path.join(out_dir, "rank0.pt"))
    finally:
        dist.destroy_process_group()


def _mesh_cg_twice(mesh):
    """Factor the 3,000-row mesh problem on ``mesh``, solve its ``'cg'``
    loop once (recorded there, with the collectives it records), then
    count a second solve."""
    from nonlinpdes_gpsolver_tpu_torch.ops import graphs
    from nonlinpdes_gpsolver_tpu_torch.parallel import comm
    from nonlinpdes_gpsolver_tpu_torch.solvers.distributed import (
        factorize_distributed, gn_solve_distributed)

    w = tpt.workloads.mesh_elliptic(device=mesh.device, n_domain=1300, n_boundary=400)
    fp = factorize_distributed(w.problem, mesh, nugget=1e-5, block=256)
    kw = dict(max_iter=3, step_solver="cg")
    comm.reset_counts()
    gn_solve_distributed(fp, **kw)
    recorded = comm.RECORDED
    graphs.reset_counts()
    comm.reset_counts()
    st = gn_solve_distributed(fp, **kw)
    torch.cuda.synchronize()
    return {"z": st.z.cpu(), "losses": st.losses.cpu(), "recorded": recorded,
            "recorded_in_replay": comm.RECORDED}


@pytest.mark.cuda
def test_group_of_one_over_nccl_records_its_loop(cuda, tmp_path):
    """A group of one over NCCL records its mesh loop as a P = 1 mesh
    without a group does, and gives its z and losses bitwise; its replayed
    solve still makes NCCL collectives outside the graphs (the route's
    host agreement)."""
    import socket

    import torch.multiprocessing as mp

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    mp.spawn(_nccl_group_of_one, args=(1, port, str(tmp_path)), nprocs=1, join=True)
    got = torch.load(tmp_path / "rank0.pt")
    one = _mesh_cg_twice(tpt.parallel.make_mesh(1, device=cuda))
    assert got["captures"] == 0 and got["replays"] > 0 and got["collectives"] > 0
    assert torch.equal(got["z"], one["z"]) and torch.equal(got["losses"], one["losses"])


@pytest.mark.cuda
def test_group_of_one_records_its_nccl_collectives(cuda, tmp_path):
    """The recorded loop of a group of one holds its NCCL collectives (the
    step code and the CG exit flag agreed on the device), where a mesh
    without a group records none; its replayed solve records nothing more
    and agrees nothing on the host but the route's structure verdict."""
    import socket

    import torch.multiprocessing as mp

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    mp.spawn(_nccl_group_of_one, args=(1, port, str(tmp_path)), nprocs=1, join=True)
    got = torch.load(tmp_path / "rank0.pt")
    one = _mesh_cg_twice(tpt.parallel.make_mesh(1, device=cuda))
    assert got["recorded"] > 0 and one["recorded"] == 0
    assert got["recorded_in_replay"] == 0 and got["agreements"] == 1


@pytest.mark.cuda
def test_warm_solves_never_synchronize_the_card(cuda, monkeypatch):
    """A warm dense solve (the canonical structure on a fresh draw) and a
    warm mesh solve run with ``torch.cuda.synchronize`` made to raise: the
    phases are timed by CUDA events, read after the solve's one host read,
    and their timers hold every key, the phases above zero."""
    mesh = tpt.parallel.make_mesh(1, device=cuda)
    w = tpt.workloads.mesh_elliptic(device=cuda, n_domain=1300, n_boundary=400)
    cases = {
        "dense": lambda k: tpt.GPSolver(_sampled_canonical(k, cuda), nugget=1e-5).solve(
            max_iter=4),
        "mesh": lambda k: tpt.GPSolver(w.problem, nugget=1e-5, mesh=mesh,
                                       mesh_block=256).solve(max_iter=4),
    }
    for run in cases.values():  # warm: entries made, loops recorded
        for k in range(3):
            run(k)

    def forbidden(*args, **kwargs):
        raise AssertionError("torch.cuda.synchronize on a solve's path")

    monkeypatch.setattr(torch.cuda, "synchronize", forbidden)
    for name, run in cases.items():
        res = run(7)
        t = res.timers
        assert set(t) == set(tpt.utils.tracing.KEYS), name
        assert min(t["factorize"], t["gauss_newton"], t["posterior_weights"]) > 0.0, (name, t)
        assert t["host_wait"] > 0.0 and t["solver_host"] > 0.0, (name, t)
        assert bool(res.state.converged_finite), name


def _bits(t):
    return t.view({4: torch.int32, 8: torch.int64}[t.element_size()])


def _eager_eval(fn, X):
    with tpt.ops.graphs.uncaptured():
        return tpt.models.elliptic._eval_on(fn, X)


def _fresh_points(seed, dtype, device, n_domain=900, n_boundary=124):
    gen = torch.Generator(device=device).manual_seed(seed)
    return tpt.utils.sample_random(gen, n_domain, n_boundary, dtype=dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_data_evaluation_replays_bitwise(cuda, dtype):
    """The benchmark's right-hand side ``-trace(hessian(u)) + u**3`` at 900
    points and ``u`` at 124 (``tpt.workloads``, the source of
    ``gpbench/frozen/truths.py``): the first build records both, a build on
    fresh points replays them with no capture and no host read, and every
    build's data is bitwise the eager ``vmap``'s."""
    from nonlinpdes_gpsolver_tpu_torch.ops import graphs

    tpt.clear_graph_cache()
    k = tpt.SquaredExponential.gaussian(0.2)
    seen = []
    for seed in range(3):
        Xd, Xb = _fresh_points(seed, dtype, cuda)
        graphs.reset_counts()
        if seed == 2:
            torch.cuda.set_sync_debug_mode("error")
        try:
            prob = tpt.models.nonlinear_elliptic(k, Xd, Xb, tpt.workloads.elliptic_rhs(),
                                                 tpt.workloads.u_elliptic)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        seen.append((graphs.EVAL_CAPTURES, graphs.EVAL_REPLAYS, graphs.EVAL_EAGER))
        assert all(e.graph is not None for e in graphs._EVALS.values()), [
            e.why for e in graphs._EVALS.values()]
        f = _eager_eval(tpt.workloads.elliptic_rhs(), Xd)
        g = _eager_eval(tpt.workloads.u_elliptic, Xb)
        assert torch.equal(_bits(prob.data["f"]), _bits(f)), seed
        assert torch.equal(_bits(prob.data["g"]), _bits(g)), seed
        t = prob.trace.seconds
        assert (t.get("build.record", 0.0) > 0.0) == (seed == 0)
        assert (t.get("build.replay", 0.0) > 0.0) == (seed > 0)
    assert seen == [(2, 0, 0), (0, 2, 0), (0, 2, 0)]
    tpt.clear_graph_cache()


@pytest.mark.cuda
def test_a_callable_that_reads_the_host_stays_eager(cuda):
    """A callable with ``.item()`` inside cannot be recorded: its first call
    gives the eager values and counts one ``EVAL_EAGER``, and later calls
    run eagerly without trying again."""
    from nonlinpdes_gpsolver_tpu_torch.ops import graphs

    tpt.clear_graph_cache()
    graphs.reset_counts()
    scale = torch.tensor(3.0, device=cuda)
    _eval_on = tpt.models.elliptic._eval_on

    def fn(x):
        return x[0] * scale.item()

    for seed in range(3):
        Xd, _ = _fresh_points(seed, torch.float32, cuda, 300, 8)
        got = _eval_on(fn, Xd)
        assert torch.equal(got, 3.0 * Xd[:, 0])
    assert (graphs.EVAL_CAPTURES, graphs.EVAL_REPLAYS, graphs.EVAL_EAGER) == (0, 0, 1)
    (entry,) = graphs._EVALS.values()
    assert entry.graph is None and entry.why
    # the card and the capture stream still work: a recordable callable records
    got = _eval_on(tpt.workloads.u_elliptic, Xd)
    assert graphs.EVAL_CAPTURES == 1, [e.why for e in graphs._EVALS.values()]
    assert torch.equal(_bits(got), _bits(_eager_eval(tpt.workloads.u_elliptic, Xd)))
    tpt.clear_graph_cache()


@pytest.mark.cuda
def test_evaluations_share_one_pool_and_stay_bitwise(cuda):
    """Three keys (the right-hand side at 900 points, ``u`` at 124 and at
    900) replayed in turns in the one pool, each bitwise its eager
    ``vmap``; the pool the cell's two keys take (f32) holds at most one
    2 MiB segment."""
    from nonlinpdes_gpsolver_tpu_torch.ops import graphs
    from nonlinpdes_gpsolver_tpu_torch.solvers import _reuse

    tpt.clear_graph_cache()
    torch.cuda.empty_cache()
    graphs.reset_counts()
    _eval_on = tpt.models.elliptic._eval_on
    rhs, u = tpt.workloads.elliptic_rhs(), tpt.workloads.u_elliptic
    Xd, Xb = _fresh_points(0, torch.float32, cuda)
    _eval_on(rhs, Xd)
    _eval_on(u, Xb)
    torch.cuda.synchronize()
    assert graphs.EVAL_CAPTURES == 2, [e.why for e in graphs._EVALS.values()]
    pool = graphs._EVAL_POOLS[Xd.device]
    reserved = _reuse._pool_bytes([pool])[tuple(pool)]
    assert 0 < reserved <= 2 * 2**20, reserved
    _eval_on(u, Xd)
    for seed in range(1, 5):
        Xd, Xb = _fresh_points(seed, torch.float32, cuda)
        order = [(rhs, Xd), (u, Xb), (u, Xd)][seed % 3:] + [(rhs, Xd), (u, Xb), (u, Xd)][:seed % 3]
        got = [_eval_on(fn, X) for fn, X in order]
        for (fn, X), out in zip(order, got):
            assert torch.equal(_bits(out), _bits(_eager_eval(fn, X))), seed
    assert (graphs.EVAL_CAPTURES, graphs.EVAL_REPLAYS, graphs.EVAL_EAGER) == (3, 12, 0)
    tpt.clear_graph_cache()
