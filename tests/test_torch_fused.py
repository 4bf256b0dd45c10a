"""The port's mesh-path assembly and fused factorization against the JAX
package's (f64, CPU, one-device meshes, the same numpy inputs), and the
port twins of ``tests/test_fused.py``: superblock partition, window cover,
the probe catching a corrupt factor, escalation, multi-chunk updates."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nonlinpdes_gpsolver_tpu.ops as jops
from nonlinpdes_gpsolver_tpu.parallel import fused as jfused
from nonlinpdes_gpsolver_tpu.parallel import gram as jgram
from nonlinpdes_gpsolver_tpu.parallel.mesh import make_mesh as jax_mesh

import nonlinpdes_gpsolver_tpu_torch as tpt
import nonlinpdes_gpsolver_tpu_torch.ops as tops
from nonlinpdes_gpsolver_tpu_torch.ops import gram_tile
from nonlinpdes_gpsolver_tpu_torch.parallel import cholesky, fused, gram, make_mesh
from torch_threads import one_torch_thread  # noqa: F401  (autouse fixture)
from torch_time_limit import time_limit  # noqa: F401  (autouse fixture)

MESH = make_mesh(1, device="cpu")


def _elliptic(pkg, n_dom=70, n_bd=22):
    rng = np.random.default_rng(0)
    pts = {"domain": rng.uniform(0, 1, (n_dom, 2)), "boundary": rng.uniform(0, 1, (n_bd, 2))}
    obs = (pkg.Observable("domain", pkg.laplacian()), pkg.Observable("domain", pkg.identity()),
           pkg.Observable("boundary", pkg.identity()))
    return pkg.SquaredExponential.gaussian(0.3), obs, pts


def _burgers(pkg):
    """Five operators on uneven segments (37 is no multiple of a block):
    superblock windows straddle segment boundaries."""
    rng = np.random.default_rng(1)
    pts = {"domain": rng.uniform(0, 1, (37, 2)), "boundary": rng.uniform(0, 1, (13, 2))}
    obs = (pkg.Observable("domain", pkg.d(0)), pkg.Observable("domain", pkg.d(1)),
           pkg.Observable("domain", pkg.d2(1, 1)), pkg.Observable("domain", pkg.identity()),
           pkg.Observable("boundary", pkg.identity()))
    return pkg.SquaredExponential.anisotropic((3.0, 20.0), "precision"), obs, pts


LAYOUTS = {"elliptic": (_elliptic, 1e-4), "burgers": (_burgers, 1e-2)}


def _pair(name):
    """(JAX kernel, obs, points), (port kernel, obs, points), nugget."""
    build, nugget = LAYOUTS[name]
    kj, oj, pj = build(jops)
    kt, ot, pt = build(tops)
    return ((kj, oj, {k: jnp.asarray(v) for k, v in pj.items()}),
            (kt, ot, {k: torch.as_tensor(v) for k, v in pt.items()}), nugget)


@pytest.mark.parametrize("name", list(LAYOUTS))
@pytest.mark.parametrize("nugget_type", ["adaptive", "identity"])
def test_equilibration_parts_match_jax(name, nugget_type):
    (kj, oj, pj), (kt, ot, pt), nugget = _pair(name)
    ref = jgram._equilibration_parts(kj, jgram._segments(oj, pj), nugget_type, nugget,
                                     jnp.float64)
    got = gram._equilibration_parts(kt, gram._segments(ot, pt), nugget_type, nugget,
                                    torch.float64)
    for a, b in zip(got, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-12)


@pytest.mark.parametrize("name", list(LAYOUTS))
def test_two_pass_assembly_matches_jax(name):
    """The whole equilibrated matrix (one K2 launch; here its plain
    version), unit diagonal and identity tail included, at rtol 1e-12."""
    (kj, oj, pj), (kt, ot, pt), nugget = _pair(name)
    ref, d_ref = jgram.assemble_gram_sharded(kj, oj, pj, jax_mesh(1), block=16, nugget=nugget,
                                             nugget_scale=10.0)
    got, d = gram.assemble_gram_sharded(kt, ot, pt, MESH, block=16, nugget=nugget,
                                        nugget_scale=10.0)
    ref = np.asarray(ref)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-12, atol=1e-12 * np.abs(ref).max())
    np.testing.assert_allclose(d.numpy(), np.asarray(d_ref), rtol=1e-12)


def _two_pass_factor(kt, ot, pt, nugget, block):
    arranged, _ = gram.assemble_gram_sharded(kt, ot, pt, MESH, block=block, nugget=nugget)
    lower, _ = cholesky._chol_sharded(arranged, MESH, "p", block)
    n = sum(tops.observable_sizes(ot, pt))
    return cholesky.unshard_rows_blockcyclic(lower, MESH, "p", block, n)


@pytest.mark.parametrize("name,block,chunk,sup", [
    ("elliptic", 8, 8, 16), ("elliptic", 8, 24, 32), ("elliptic", 16, 10**9, 16),
    ("elliptic", 16, 64, 10**9), ("burgers", 8, 16, 24), ("burgers", 16, 16, 32),
])
def test_fused_factor_matches_two_pass(name, block, chunk, sup):
    """The superblock left-looking factor against the two-pass factor of the
    same matrix, at the block/chunk/superblock widths of tests/test_fused.py
    (P = 1): 1e-8 (f64; the orders of the sums differ); the sampled-row
    probe then holds it to independently assembled rows at 1e-8."""
    _, (kt, ot, pt), nugget = _pair(name)
    res = fused.assemble_factor_fused(kt, ot, pt, MESH, block=block, nugget=nugget,
                                      chunk_cols=chunk, superblock_cols=sup)
    assert res.ok and res.scale == 1.0 and res.attempts == 1
    nb = res.factor.n_pad // block
    assert res.superblocks == len(fused._superblocks(nb, max(1, sup // block)))
    two_pass = _two_pass_factor(kt, ot, pt, nugget, block)
    assert float((res.factor.dense() - two_pass).abs().max()) < 1e-8
    assert float(res.factor.matrix.triu(1).abs().max()) == 0.0  # a clean lower factor
    q = fused.sampled_row_quality(res.factor, kt, ot, pt, res.d_isqrt)
    assert np.isfinite(q) and q < 1e-8


@pytest.mark.parametrize("name,block,chunk,sup", [("elliptic", 8, 24, 32), ("burgers", 8, 16, 24)])
def test_fused_factor_matches_jax(name, block, chunk, sup):
    """The fused factor, its diagonal-block inverses and d^{-1/2} against
    the JAX package's fused factor on a one-device mesh: 1e-8."""
    (kj, oj, pj), (kt, ot, pt), nugget = _pair(name)
    jf, jd, js, jok = jfused.assemble_factor_fused(kj, oj, pj, jax_mesh(1), block=block,
                                                   nugget=nugget, chunk_cols=chunk,
                                                   superblock_cols=sup)
    res = fused.assemble_factor_fused(kt, ot, pt, MESH, block=block, nugget=nugget,
                                      chunk_cols=chunk, superblock_cols=sup)
    assert bool(jok) and res.ok and float(js) == res.scale
    assert float(np.abs(res.factor.dense().numpy() - np.asarray(jf.dense())).max()) < 1e-8
    assert float(np.abs(res.factor.diag_inv.numpy() - np.asarray(jf.diag_inv)).max()) < 1e-8
    np.testing.assert_allclose(res.d_isqrt.numpy(), np.asarray(jd), rtol=1e-12)
    qj = float(jfused.sampled_row_quality(jf, kj, oj, pj, jd))
    qt = fused.sampled_row_quality(res.factor, kt, ot, pt, res.d_isqrt)
    assert qt < 1e-8 and qj < 1e-8


def test_superblock_partition():
    assert fused._superblocks(12, 4) == [(0, 4), (4, 4), (8, 4)]
    assert fused._superblocks(13, 4) == [(0, 4), (4, 4), (8, 4), (12, 1)]
    assert fused._superblocks(5, 100) == [(0, 5)]
    for nb in (1, 5, 12, 108):
        for F in (1, 3, 8, 1000):
            sbs = fused._superblocks(nb, F)
            assert sbs == jfused._superblocks(nb, F)
            assert sbs[0][0] == 0 and sum(f for _, f in sbs) == nb
            for (a, fa), (b, _) in zip(sbs, sbs[1:]):
                assert a + fa == b


def test_seg_ranges_cover_window():
    _, obs, pts = _elliptic(tops)
    pts = {k: torch.as_tensor(v) for k, v in pts.items()}
    segs = gram._segments(obs, pts)
    n = 162
    for c0, c1 in [(0, 64), (64, 160), (128, 192), (160, 192), (0, 192)]:
        ranges = fused._seg_ranges(segs, c0, c1, n)
        spans = sorted((lo, hi) for _, lo, hi in ranges)
        assert spans[0][0] == 0 and spans[-1][1] == c1 - c0
        for (a, b), (c, e) in zip(spans, spans[1:]):
            assert b == c
        for op, lo, hi in ranges:
            if c0 + lo >= n:
                assert op is None


def _cover(plan):
    """How often the kernel writes each entry of the plan's output."""
    cover = np.zeros(plan.shape, np.int64)
    for index in range(plan.n_tiles):
        b, tr, tc = plan.tile_coords(index)
        blk = plan.blocks[b]
        r0, c0 = blk.row_off + tr * gram_tile.TILE, blk.col_off + tc * gram_tile.TILE
        cover[r0 : min(r0 + gram_tile.TILE, blk.row_off + blk.n),
              c0 : min(c0 + gram_tile.TILE, blk.col_off + blk.m)] += 1
    return cover


def _darcy_u_observables():
    return (tops.Observable("domain", tops.d(0)), tops.Observable("domain", tops.d(1)),
            tops.Observable("domain", tops.laplacian()), tops.Observable("domain", tops.identity()),
            tops.Observable("boundary", tops.identity()))


@pytest.mark.parametrize("n_dom,block,sup", [(300, 512, 2048), (3000, 512, 2048), (37, 8, 24)])
def test_darcy_u_windows_fit_the_plan_limits(n_dom, block, sup):
    """The worst layout, Darcy's u block (5 observables on 2 point sets):
    every window's K2 plan fits the kernel's limits (sets <= 8, blocks <= 36,
    merged terms <= 128), pairs each row range with each column range once,
    and covers each entry of its strip exactly once, padding included."""
    obs = _darcy_u_observables()
    sizes = (n_dom,) * 4 + (n_dom // 4,)
    n = sum(sizes)
    n_pad = cholesky.pad_to_blocks(n, block, 1)
    most = 0
    for kb0, F in fused._superblocks(n_pad // block, sup // block):
        c0, c1 = kb0 * block, (kb0 + F) * block
        plan = fused.window_plan(tops.SquaredExponential.gaussian(0.2), obs, sizes, c0, c1, n_pad)
        assert plan.equilibrated and not any(b.mirror or b.symmetric for b in plan.blocks)
        assert len(plan.set_sizes) <= 8 and len(plan.blocks) <= 36
        assert len(plan._arrays["coef"]) <= 128
        assert (_cover(plan) == 1).all()
        fill = sum(b.n * b.m for b in plan.blocks if b.fill)
        assert fill == plan.shape[0] * plan.shape[1] - (n - c0) * (min(n, c1) - c0)
        most = max(most, sum(not b.fill for b in plan.blocks))
    if n_dom == 300:
        assert most == 25  # one window holds every pair of the 5 observables


def test_sampled_row_probe_catches_corruption():
    """A finite but wrong factor fails the probe (the miscompile class)."""
    _, (kt, ot, pt), _ = _pair("elliptic")
    res = fused.assemble_factor_fused(kt, ot, pt, MESH, block=8, nugget=1e-4)
    assert fused.sampled_row_quality(res.factor, kt, ot, pt, res.d_isqrt) < 1e-8
    bad = dataclasses.replace(res.factor, local=res.factor.local * 1.01)
    assert fused.sampled_row_quality(bad, kt, ot, pt, res.d_isqrt) > 1e-2


@pytest.mark.parametrize("failure", ["superblock", "probe", "two_pass"])
def test_factorize_distributed_escalates(monkeypatch, failure):
    """The escalation ladder (tests/test_fused.py:200), on duplicated
    collocation points with the bi-Laplacian block at nugget 1e-6. The
    port's f64 Cholesky factors that matrix at the first scale where the
    JAX package's f32 one fails, so each failure is injected once: a
    superblock diagonal whose Cholesky fails (the fused path's in-place
    restart), a probe verdict of NaN (the host ladder), a NaN two-pass
    factor. Each costs one tenfold rung, and the accepted factor is the one
    a start at that scale gives, and whitens to finite values."""
    from nonlinpdes_gpsolver_tpu_torch.solvers import distributed

    rng = np.random.default_rng(0)
    Xd = torch.as_tensor(np.concatenate([rng.uniform(0, 1, (30, 2))] * 4))
    Xb = torch.as_tensor(rng.uniform(0, 1, (12, 2)))
    prob = tpt.models.nonlinear_elliptic(tpt.SquaredExponential.gaussian(0.3), Xd, Xb,
                                         None, None, seed=1)
    kw = dict(nugget=1e-6, block=16, superblock_cols=64, fused=failure != "two_pass")
    want = tpt.solvers.factorize_distributed(prob, MESH, start_scales={"u": 10.0}, **kw)
    calls = []

    def once(real, fail):
        def patched(*a, **k):
            out = real(*a, **k)
            calls.append(1)
            return fail(out) if len(calls) == 1 else out
        return patched

    if failure == "superblock":
        monkeypatch.setattr(fused, "cholesky_f64", once(fused.cholesky_f64, lambda o: (o[0], False)))
    elif failure == "probe":
        monkeypatch.setattr(distributed, "sampled_row_quality",
                            once(distributed.sampled_row_quality, lambda q: float("nan")))
    else:
        monkeypatch.setattr(distributed, "_chol_sharded", once(
            distributed._chol_sharded, lambda o: (o[0].fill_(float("nan")), o[1])))
    dfp = tpt.solvers.factorize_distributed(prob, MESH, **kw)
    assert dfp.nugget_scales["u"] == 10.0 and dfp.rungs["u"] == 1
    assert dfp.stats["u"]["attempts"] == 2
    if failure == "superblock":  # the failed attempt stopped at its first superblock
        assert dfp.stats["u"]["superblocks"] == want.stats["u"]["superblocks"] + 1
    assert float((dfp.factors["u"].matrix - want.factors["u"].matrix).abs().max()) == 0.0
    assert bool(torch.isfinite(dfp.whitened_residual(prob.init_latent())).all())


def test_fused_multi_chunk_update():
    """Narrow update chunks (many GEMMs a superblock) give the factor of one
    GEMM a superblock, to rounding (f64: 1e-12)."""
    _, (kt, ot, pt), nugget = _pair("elliptic")
    one = fused.assemble_factor_fused(kt, ot, pt, MESH, block=8, nugget=nugget,
                                      superblock_cols=32, chunk_cols=10**9)
    many = fused.assemble_factor_fused(kt, ot, pt, MESH, block=8, nugget=nugget,
                                       superblock_cols=32, chunk_cols=8)
    assert float((one.factor.matrix - many.factor.matrix).abs().max()) < 1e-12


def test_fused_refuses_tf32(monkeypatch):
    _, (kt, ot, pt), nugget = _pair("elliptic")
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    with pytest.raises(RuntimeError, match="allow_tf32"):
        fused.assemble_factor_fused(kt, ot, pt, MESH, block=8, nugget=nugget)


@pytest.mark.parametrize("ranks,rank", [(1, 0), (2, 0), (2, 1), (4, 3)])
def test_k2_walk_covers_ragged_windows_once(ranks, rank):
    """K2's walk (``GramPlan.k2_tiles``) over every superblock window of the
    elliptic layout at 300 + 45 points (segments of 300, 300 and 45 rows:
    ragged tiles; 32-row blocks, 256-wide superblocks: a rank's 64-row tile
    skips columns between its row blocks), on one device and rank-mapped
    (rank 3 of 4's last block lies in the padding): every entry of the
    window written exactly once; exactly the tiles that hold a unit-
    diagonal entry (a row whose window row is a column of the tile) flagged;
    a TMA box starting on a 16-byte boundary and, clipped at the output's
    edge, exactly its tile; and no TMA store into an output the box cannot
    describe (a row stride of no 16-byte multiple)."""
    kt, ot, pt = _elliptic(tops, 300, 45)
    sizes = tops.observable_sizes(ot, {k: torch.as_tensor(v) for k, v in pt.items()})
    n_pad = cholesky.pad_to_blocks(sum(sizes), 32, ranks)
    kinds = set()
    for kb0, F in fused._superblocks(n_pad // 32, 8):
        c0, c1 = kb0 * 32, (kb0 + F) * 32
        plan = fused.window_plan(kt, ot, sizes, c0, c1, n_pad, ranks, rank, 32)
        h, S = plan.shape
        if h == 0:
            continue
        w = plan.window_rows().numpy()
        diagonal = np.zeros((h, S), bool)
        on = w < S
        diagonal[np.nonzero(on)[0], w[on]] = True
        cover = np.zeros((h, S), np.int64)
        out = torch.empty((h, S), dtype=torch.float64)
        for rows, cols, diag, by_tma in plan.k2_tiles(out):
            cover[rows, cols] += 1
            assert diag == bool(diagonal[rows, cols].any()), (c0, rows, cols)
            if by_tma:
                box = (slice(rows.start, min(rows.start + gram_tile.TILE, h)),
                       slice(cols.start, min(cols.start + gram_tile.TILE, S)))
                assert box == (rows, cols) and cols.start % 2 == 0
            kinds.add((diag, by_tma))
        assert (cover == 1).all()
        unaligned = torch.empty((h, S + 1), dtype=torch.float64)[:, :S]
        assert not any(t[3] for t in plan.k2_tiles(unaligned))
    assert kinds == {(d, t) for d in (False, True) for t in (False, True)}


def test_k2_plain_version_and_plan_checks():
    """K2's plain version writes ``1 if i == j else d_r[i] d_c[j] K[i, j]``
    (the padding 0 off the diagonal) into a strided slot; a K2 plan refuses
    ``run``, mirrors and K1's entry point takes no fill blocks."""
    _, (kt, ot, pt), _ = _pair("elliptic")
    sizes = tops.observable_sizes(ot, pt)
    plan = fused.window_plan(kt, ot, sizes, 64, 128, 168)
    sets = gram.window_sets(plan, pt)
    d = torch.linspace(0.5, 1.5, 168, dtype=torch.float64)
    big = torch.full((110, 70), 7.0, dtype=torch.float64)
    plan.run_equilibrated(sets, d[64:], d[64:128], out=big[3:107, 2:66])
    theta = tops.gram_matrix(kt, ot, pt)
    full = torch.eye(168, dtype=torch.float64)
    full[:162, :162] = theta * torch.outer(d[:162], d[:162])
    full.fill_diagonal_(1.0)
    torch.testing.assert_close(big[3:107, 2:66], full[64:, 64:128], rtol=1e-12, atol=1e-14)
    big[3:107, 2:66] = 7.0
    assert bool((big == 7.0).all())
    with pytest.raises(ValueError, match="run_equilibrated"):
        plan.run(sets)
    with pytest.raises(ValueError, match="mirrored"):
        gram_tile.GramPlan(kt, [(tops.identity(), tops.identity(), 0, 0, 0, 0, True)], (4,),
                           (4, 4), equilibrated=True)
    with pytest.raises(ValueError, match="fill"):
        gram_tile.GramPlan(kt, [], (4,), (4, 4), fills=[(0, 0, 4, 4)])
    with pytest.raises(ValueError, match="window"):
        fused.window_plan(kt, ot, sizes, 162, 168, 168)  # all padding
