"""The traffic generator and the draws: the same ``(seed, k)`` gives the
same problem, another ``k`` another one."""

import json
from pathlib import Path

import pytest
import torch

from gpbench import generator
from gpbench.pdes import darcy_flow2d_inverse, nonlin_elliptic2d

ROOT = Path(__file__).resolve().parents[2]
CFG = ROOT / "gpbench" / "configs"
SEED = 3_000_023_757  # larger than 32 signed bits hold, as a check's seeds are


def _cfg(name):
    return json.loads((CFG / f"{name}.json").read_text())


def _same(a: dict, b: dict) -> bool:
    return a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)


@pytest.mark.parametrize("pde,sizes", [
    (nonlin_elliptic2d, {"n_domain": 40, "n_boundary": 12, "mesh": 0}),
    (darcy_flow2d_inverse, {"n_domain": 40, "n_boundary": 12, "n_obs": 10, "mesh": 1}),
])
def test_draws_repeat_for_a_seed_and_differ_across_solves(pde, sizes):
    cfg = _cfg(pde.__name__.rsplit(".", 1)[1])
    ctx = pde.setup(cfg, "cpu", torch.float64)
    def draw(seed, k):
        gen = torch.Generator().manual_seed(generator.solve_seed(seed, k))
        return pde.draw(cfg, sizes, gen, torch.float64, ctx)

    first = draw(SEED, 0)
    assert _same(first, draw(SEED, 0))
    for other in (draw(SEED, 1), draw(SEED + 1, 0)):
        assert not torch.equal(first["X_domain"], other["X_domain"])
        assert not torch.equal(first["z0"], other["z0"])
    assert first["X_domain"].shape == (40, 2) and first["X_boundary"].shape == (12, 2)
    assert float(first["X_domain"].min()) >= 0.0 and float(first["X_domain"].max()) <= 1.0


def test_solve_seeds_are_distinct_and_take_any_integer():
    seeds = {generator.solve_seed(s, k) for s in (0, 1, SEED, -5, 2**40) for k in range(50)}
    assert len(seeds) == 250
    assert all(0 <= s < 2**63 for s in seeds)


def test_a_mix_has_one_size_and_refuses_lists(tmp_path):
    assert generator.sizes({"n_domain": 5, "n_boundary": 3}) == {
        "mesh": 0, "n_domain": 5, "n_boundary": 3}
    path = tmp_path / "cycle.json"
    path.write_text(json.dumps({"n_domain": [900, 1000], "n_boundary": 124}))
    with pytest.raises(ValueError):
        generator.load(path)


def test_every_mix_loads():
    for path in sorted((ROOT / "gpbench" / "traffic").glob("*.json")):
        mix = generator.load(path)
        assert generator.sizes(mix)["n_domain"] > 0
