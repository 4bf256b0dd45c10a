"""The roofline's work count against counts made by hand."""

import pytest

from gpbench.frozen import roofline as rl


def test_merged_terms_of_the_laplacian_pair():
    # lap (x) lap: d4/dx1^4, d4/dx2^4 and the mixed term 2 d4/dx1^2 dx2^2
    assert sorted(rl.merged_terms(rl.LAPLACIAN, rl.LAPLACIAN)) == [(0, 4), (2, 2), (4, 0)]
    assert rl.merged_terms(rl.IDENTITY, rl.IDENTITY) == [(0, 0)]
    assert rl.merged_terms(rl.D0, rl.D1) == [(1, 1)]


def test_entry_operations_by_hand():
    base = 2 + 6 + 25 + 1  # u, q, exp, the final product
    assert rl.entry_ops(rl.IDENTITY, rl.IDENTITY) == base + 1
    assert rl.entry_ops(rl.LAPLACIAN, rl.IDENTITY) == base + 2 * (1 + 5)
    assert rl.entry_ops(rl.LAPLACIAN, rl.LAPLACIAN) == base + (1 + 9) * 2 + (1 + 5 + 5)
    assert rl.entry_ops(rl.D0, rl.D1, equilibrated=True) == base + 2 + (1 + 3 + 3)


def test_small_gram_work_by_hand():
    # segments: the Laplacian at 3 points, the identity at those 3 and at 2 more
    segs = [(rl.LAPLACIAN, 3), (rl.IDENTITY, 3), (rl.IDENTITY, 2)]
    base = 34
    ll, li, ii = base + 31, base + 12, base + 1
    # distinct entries: lap-lap 6, id-lap 3*3 + 2*3, id-id 6 + 2*3 + 3
    flops = 6 * ll + (9 + 6) * li + (6 + 6 + 3) * ii
    w = rl.gram_work(segs, points=5, esize=4)
    assert w.flops == flops
    assert w.bytes == 4 * (8 * 8 + 5 * 2)
    lower = rl.gram_work(segs, points=5, esize=4, lower_only=True, equilibrated=True)
    assert lower.bytes == 4 * (8 * 9 // 2 + 5 * 2 + 8)
    assert lower.flops == flops + 2 * (8 * 9 // 2)


def test_cross_work_and_the_binding_limit():
    segs = [(rl.LAPLACIAN, 3), (rl.IDENTITY, 5)]
    w = rl.cross_work(4, rl.IDENTITY, segs, points=5, esize=4)
    assert w.flops == 4 * 3 * (34 + 12) + 4 * 5 * 35
    assert w.bytes == 4 * (4 * 8 + (4 + 5) * 2)
    t, by = rl.least_seconds(rl.Work(flops=67e12, bytes=1.0))
    assert by == "operations" and t == pytest.approx(1.0)
    t, by = rl.least_seconds(rl.Work(flops=1.0, bytes=3.35e12))
    assert by == "bytes" and t == pytest.approx(1.0)
