"""The Gram kernel's launch plans on the CPU: a walk of the descriptors,
as the kernel walks them, covers every entry of the output exactly once;
the plan's tables are ``pack_terms`` of its operator pairs; and the plan's
plain version, which ``gram_matrix`` and ``cross_gram`` run on the CPU,
matches the per-block closed form and the JAX package."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nonlinpdes_gpsolver_tpu.ops as jops
import nonlinpdes_gpsolver_tpu_torch.ops as tops
from nonlinpdes_gpsolver_tpu_torch.ops import gram_tile
from torch_threads import one_torch_thread  # noqa: F401  (autouse fixture)
from torch_time_limit import time_limit  # noqa: F401  (autouse fixture)

TILE = gram_tile.TILE
KERNEL = tops.SquaredExponential.anisotropic([0.3, 0.05])
SIZES = [1, 33, 64, 65, 130]


def _observables(pkg):
    return (
        pkg.Observable("a", pkg.laplacian()),
        pkg.Observable("a", pkg.identity()),
        pkg.Observable("b", pkg.d(0)),
        pkg.Observable("b", pkg.identity()),
        pkg.Observable("c", pkg.d2(1, 1)),
    )


def _points(n_a, n_b, n_c, seed=0):
    rng = np.random.default_rng(seed)
    return {k: rng.uniform(0, 1, (n, 2)) for k, n in (("a", n_a), ("b", n_b), ("c", n_c))}


def _torch_pts(pts):
    return {k: torch.as_tensor(v, dtype=torch.float64) for k, v in pts.items()}


def _coverage(plan):
    """How often the kernel writes each output entry: each tile of the flat
    list (mapped as the kernel maps a CTA's tile index), plus its transpose
    where the tile is mirrored."""
    cover = np.zeros(plan.shape, np.int64)
    for index in range(plan.n_tiles):
        b, tr, tc = plan.tile_coords(index)
        blk = plan.blocks[b]
        r0, c0 = tr * TILE, tc * TILE
        rows, cols = min(TILE, blk.n - r0), min(TILE, blk.m - c0)
        assert rows > 0 and cols > 0, (blk, tr, tc)
        if blk.symmetric:
            assert tc >= tr, "symmetric blocks compute upper tiles only"
        rs = slice(blk.row_off + r0, blk.row_off + r0 + rows)
        cs = slice(blk.col_off + c0, blk.col_off + c0 + cols)
        cover[rs, cs] += 1
        if blk.mirror or (blk.symmetric and tr != tc):
            cover[cs, rs] += 1
    return cover


@pytest.mark.parametrize("n_a", SIZES)
@pytest.mark.parametrize("n_b", [1, 65])
def test_gram_plan_walk_covers_every_entry_once(n_a, n_b):
    obs = _observables(tops)
    sizes = tops.observable_sizes(obs, _torch_pts(_points(n_a, n_b, 33)))
    plan = gram_tile.gram_plan(KERNEL, obs, sizes)
    assert plan.shape == (sum(sizes),) * 2
    assert sum(b.symmetric for b in plan.blocks) == 5  # the diagonal blocks
    assert sum(b.mirror for b in plan.blocks) == 10  # the upper off-diagonal ones
    assert (_coverage(plan) == 1).all()


@pytest.mark.parametrize("n_rows", SIZES)
def test_cross_plan_walk_covers_every_entry_once(n_rows):
    obs = _observables(tops)
    sizes = tops.observable_sizes(obs, _torch_pts(_points(65, 130, 1)))
    plan = gram_tile.cross_plan(KERNEL, tops.laplacian(), n_rows, obs, sizes)
    assert plan.shape == (n_rows, sum(sizes))
    assert not any(b.mirror or b.symmetric for b in plan.blocks)
    assert (_coverage(plan) == 1).all()


@pytest.mark.parametrize("n", SIZES)
def test_diagonal_blocks_symmetric_only_for_one_operator(n):
    """On the diagonal, the same operator on the same points is computed as
    upper tiles; two operators on the same points are computed in full."""
    ops = [(tops.identity(), tops.identity()), (tops.laplacian(), tops.identity())]
    entries = [(ox, oy, 0, 0, i * n, i * n, False) for i, (ox, oy) in enumerate(ops)]
    plan = gram_tile.GramPlan(KERNEL, entries, (n,), (2 * n, 2 * n))
    assert [b.symmetric for b in plan.blocks] == [True, False]
    tiles = -(-n // TILE)
    assert [b.tiles for b in plan.blocks] == [tiles * (tiles + 1) // 2, tiles * tiles]
    cover = _coverage(plan)
    assert (cover[:n, :n] == 1).all() and (cover[n:, n:] == 1).all()
    assert (cover[:n, n:] == 0).all() and (cover[n:, :n] == 0).all()


def test_plan_tile_prefix_sums_and_empty_blocks():
    obs = _observables(tops)
    plan = gram_tile.gram_plan(KERNEL, obs, (130, 130, 0, 0, 7))
    assert len(plan.blocks) == 6  # the blocks of the empty point set are dropped
    starts = np.cumsum([0] + [b.tiles for b in plan.blocks])
    assert [b.tile_start for b in plan.blocks] == starts[:-1].tolist()
    assert plan.n_tiles == starts[-1]
    assert plan._arrays["blocks"][:, -1].tolist() == starts[:-1].tolist()


def test_plan_tables_are_pack_terms_of_each_pair():
    obs = _observables(tops)
    plan = gram_tile.gram_plan(KERNEL, obs, (65, 65, 33, 33, 7))
    distinct = {(a.op.terms, b.op.terms) for i, a in enumerate(obs) for b in obs[i:]}
    assert len(plan.pairs) == len(plan.tables) == len(distinct) == 11  # repeats share one
    arrays, dim = plan._arrays, KERNEL.dim
    stride = gram_tile.MAX_DEGREE + 1
    for (ox, oy), (table, degs), lo, hi in zip(
        plan.pairs, plan.tables, arrays["term_start"][:-1], arrays["term_start"][1:]
    ):
        ref_table, ref_degs = gram_tile.pack_terms(KERNEL.inv_sq, ox.terms, oy.terms)
        np.testing.assert_array_equal(table, ref_table)
        np.testing.assert_array_equal(degs, ref_degs)
        # the kernel's arrays hold the same coefficients and degrees
        rows = table[dim:].reshape(len(degs), 1 + dim * stride)
        np.testing.assert_array_equal(arrays["coef"][lo:hi], rows[:, 0])
        np.testing.assert_array_equal(arrays["degs"][lo:hi], degs)
        for row, deg in zip(rows, degs):
            for k, b in enumerate(deg):
                cf = row[1 + k * stride : 1 + k * stride + b + 1]
                np.testing.assert_array_equal(arrays["poly"][k, b, : b // 2 + 1], cf[b::-2])
                # p_b has the parity of b: the skipped coefficients are zero
                assert not cf[b - 1 :: -2].any()


def test_plan_limits_raise():
    X = torch.zeros((4, 2), dtype=torch.float64)
    many = tuple(tops.Observable("p", tops.d2(i % 2, j % 2)) for i in range(3) for j in range(3))
    with pytest.raises(ValueError, match="blocks"):
        tops.gram_matrix(KERNEL, many, {"p": X})
    nine = {f"s{i}": X for i in range(9)}
    with pytest.raises(ValueError, match="point sets"):
        tops.gram_matrix(KERNEL, tuple(tops.Observable(k, tops.identity()) for k in nine), nine)
    with pytest.raises(ValueError, match="outside"):
        gram_tile.GramPlan(KERNEL, [(tops.identity(), tops.identity(), 0, 0, 0, 1, True)],
                           (4,), (4, 5))  # the mirror needs 5 rows
    deep = tops.LinearOp(2, ((1.0, (3, 0)), (1.0, (0, 3)), (1.0, (2, 1)), (1.0, (1, 2))))
    ops = [float(c) * deep for c in range(1, 7)]  # 36 distinct pairs of 7 merged terms
    with pytest.raises(ValueError, match="merged terms"):
        gram_tile.GramPlan(KERNEL, [(a, b, 0, 0, 0, 0, False) for a in ops for b in ops],
                           (4,), (4, 4))


def test_plain_plan_is_the_per_block_closed_form():
    """On the CPU a plan runs the closed form block by block: each upper
    block equals ``pair_fn``, each mirror is its exact transpose, and each
    symmetric diagonal block is the upper triangle of ``pair_fn`` mirrored."""
    pts = _torch_pts(_points(65, 33, 7, seed=3))
    obs = _observables(tops)
    before = gram_tile.LAUNCHES
    theta = tops.gram_matrix(KERNEL, obs, pts)
    assert gram_tile.LAUNCHES == before
    plan = gram_tile.gram_plan(KERNEL, obs, tops.observable_sizes(obs, pts))
    sets = [pts[k] for k in plan.set_keys]
    for b in plan.blocks:
        ox, oy = plan.pairs[b.table]
        ref = KERNEL.pair_fn(ox, oy)(sets[b.x_set], sets[b.y_set])
        got = theta[b.row_off : b.row_off + b.n, b.col_off : b.col_off + b.m]
        if b.symmetric:
            assert torch.equal(torch.triu(got), torch.triu(ref))
        else:
            assert torch.equal(got, ref)
        if b.mirror:
            assert torch.equal(theta[b.col_off : b.col_off + b.m, b.row_off : b.row_off + b.n], got.T)
    assert torch.equal(theta, theta.T)


@pytest.mark.parametrize("sizes", [(1, 33, 7), (65, 1, 130)])
def test_ragged_gram_and_cross_gram_match_jax(sizes):
    """Five observables of every derivative parity on three ragged point
    sets: the same closed form as the JAX package, rtol 1e-12 in f64."""
    pts = _points(*sizes, seed=4)
    jk = jops.SquaredExponential.anisotropic([0.3, 0.05])
    jpts = {k: jnp.asarray(v) for k, v in pts.items()}
    ref = np.asarray(jops.gram_matrix(jk, _observables(jops), jpts))
    got = tops.gram_matrix(KERNEL, _observables(tops), _torch_pts(pts))
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-12, atol=1e-12 * np.abs(ref).max())
    X = np.random.default_rng(5).uniform(0, 1, (29, 2))
    ref = np.asarray(jops.cross_gram(jk, jops.laplacian(), jnp.asarray(X), _observables(jops), jpts))
    got = tops.cross_gram(KERNEL, tops.laplacian(), torch.as_tensor(X), _observables(tops),
                          _torch_pts(pts))
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-12, atol=1e-12 * np.abs(ref).max())


def test_plans_are_cached_per_layout():
    obs = _observables(tops)
    a = gram_tile.gram_plan(KERNEL, obs, (65, 65, 33, 33, 7))
    assert gram_tile.gram_plan(KERNEL, obs, (65, 65, 33, 33, 7)) is a
    assert gram_tile.gram_plan(KERNEL, obs, (64, 64, 33, 33, 7)) is not a
    assert a.set_keys == ("a", "b", "c")
