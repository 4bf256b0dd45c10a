"""The one generator of the benchmark's traffic, driven by a mix's data file.

A mix (``traffic/<name>.json``) describes a caller that solves one problem
after another, in a closed loop, each held until the next returns
(``res = GPSolver(p).solve()`` in a loop):

* ``n_domain``, ``n_boundary`` (and ``n_obs`` for problems with
  observations): the sizes of every solve;
* ``mesh``: 0 for the program's own choice of path, P for
  ``mesh=make_mesh(P)``.

Solve ``k`` of a run with seed ``s`` draws its inputs from the 63-bit seed
:func:`solve_seed` ``(s, k)``: the same seed gives the same stream of
problems, and every solve a new one.
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np

SIZE_KEYS = ("n_domain", "n_boundary", "n_obs")


def load(path: Path) -> dict:
    mix = json.loads(Path(path).read_text())
    for key in SIZE_KEYS:
        if key in mix and not isinstance(mix[key], int):
            raise ValueError(f"{path}: {key} must be one whole number")
    return mix


def solve_seed(seed: int, k: int) -> int:
    """The seed of solve ``k`` of a run with seed ``seed`` (any integer)."""
    state = np.random.SeedSequence([int(seed) % 2**64, int(k)]).generate_state(2, np.uint32)
    return (int(state[0]) << 31) ^ int(state[1])


def sizes(mix: dict) -> dict:
    """The sizes and path of every solve of the mix."""
    return {"mesh": int(mix.get("mesh", 0)), **{k: int(mix[k]) for k in SIZE_KEYS if k in mix}}
