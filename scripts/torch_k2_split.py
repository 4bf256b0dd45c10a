#!/usr/bin/env python3
"""Where the equilibrated Gram strip kernel K2 spends its time, on one CUDA card.

    python3 scripts/torch_k2_split.py [--reference OLD.cu] [--extra TAG=FLAGS ...] [--out FILE]

Builds ``csrc/gram_tile.cu`` three times into ``_build/split/``: as it is,
with ``-DK1_SPLIT_NO_STORE`` (no global stores) and with
``-DK1_SPLIT_NO_EVAL`` (no evaluation). ``--reference`` adds a build of an
older ``gram_tile.cu`` given by path (``git show REV:nonlinpdes_gpsolver_tpu_torch/csrc/gram_tile.cu``
into a file), and each ``--extra TAG=FLAGS`` a build of the source with
more ``nvcc`` flags (say ``ctas1=-DK2_CTAS_PER_SM=1``).

Its launches are those of ``chip_smoke.py``'s ``mesh_solve``: the 21
superblock windows of ``workloads.mesh_elliptic`` (42,500 Gram rows,
512-row blocks, 2,048-wide superblocks, f32; ``chip_smoke.window_cases``),
and the same windows rank-mapped on ranks 0 and 1 of 2. Every window of
the build as it is is held to its plain version (``chip_smoke.check_k2``)
and, with ``--reference``, compared bitwise with the reference build's
output. Then each build is timed on each window (CUDA events, as
``chip_smoke.py`` times), the builds in turns, each twice.

Prints one JSON line of sums per build and turn (ms, bound, share of the
bound), one of the ptxas lines of each build, then the card's name and
power limit; ``--out`` writes the per-window times, bounds, errors and the
bitwise comparison to a JSON file.
"""

import argparse
import json
import os
import sys

sys.path.insert(0, os.getcwd())
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
import nonlinpdes_gpsolver_tpu_torch as tpt  # noqa: E402
from torch_k1_split import VARIANTS, build, use  # noqa: E402


def switch(lib_path, plans):
    """Point the wrapper at one build and drop the plans' packed
    parameters (builds of different sources may lay them out differently)."""
    use(lib_path)
    for plan in plans:
        plan._params = {}


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reference", help="an older gram_tile.cu to build, time and compare with")
    ap.add_argument("--extra", action="append", default=[],
                    help="TAG=FLAGS: one more build of the source with these nvcc flags")
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--out", help="a JSON file for the per-window numbers")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("torch_k2_split: no CUDA card")
    dev = torch.device("cuda")
    w = tpt.workloads.mesh_elliptic(device=dev)
    blk, pts = w.problem.blocks[0], w.problem.points
    groups = {"windows": cs.window_cases(blk, pts, w.nugget)}
    for p in (0, 1):
        groups[f"rank {p} of 2"] = cs.window_cases(blk, pts, w.nugget, ranks=2, rank=p)
    cases = [c for g in groups.values() for c in g]
    plans = [c[1] for c in cases]

    variants = dict(VARIANTS)
    for item in args.extra:
        tag, flags = item.split("=", 1)
        variants[tag] = flags.split()
    built = {tag: build(tag, defs) for tag, defs in variants.items()}
    if args.reference:
        built["reference"] = build("reference", [], args.reference)
    libs = {tag: path for tag, (path, _) in built.items()}

    switch(libs["kernel"], plans)
    checked = {name: cs.check_k2(name, plan, sets, d_r, d_c)
               for name, plan, sets, d_r, d_c in cases}
    bitwise = None
    if args.reference:
        bitwise = {}
        for name, plan, sets, d_r, d_c in cases:
            outs = []
            for tag in ("kernel", "reference"):
                switch(libs[tag], [plan])
                outs.append(plan.run_equilibrated(sets, d_r, d_c))
            bitwise[name] = bool(torch.equal(*outs))
            del outs
        cs.check(all(bitwise.values()), "K2 differs from the reference build: "
                 + ", ".join(n for n, same in bitwise.items() if not same))

    bufs = {name: torch.empty(plan.shape, device=dev) for name, plan, *_ in cases}
    ms = {}
    order = list(libs)
    for turn, tags in enumerate((order, order[::-1])):
        for tag in tags:
            switch(libs[tag], plans)
            for name, plan, sets, d_r, d_c in cases:
                t = cs.time_ms(lambda: plan.run_equilibrated(sets, d_r, d_c, out=bufs[name]),
                               args.reps)
                ms.setdefault(name, {}).setdefault(tag, [None, None])[turn] = t
    bounds = {name: cs.k1_bound_ms(plan, "float32")[0] for name, plan, *_ in cases}
    sums = {}
    for group, members in groups.items():
        names = [c[0] for c in members]
        bound = sum(bounds[n] for n in names)
        sums[group] = {"launches": len(names), "bound_ms": bound}
        for tag in libs:
            turns = [sum(ms[n][tag][k] for n in names) for k in (0, 1)]
            shares = [bounds[n] / ms[n][tag][k] for n in names for k in (0, 1)]
            sums[group][tag] = {"ms": turns, "share_of_bound": [bound / t for t in turns],
                                "window_share_min_max": [min(shares), max(shares)]}
    card = cs.smi("name,power.limit")
    if args.out:
        with open(args.out, "w") as fh:
            json.dump({"card": card, "sums": sums, "ms": ms, "bound_ms": bounds,
                       "bitwise_equal_to_reference": bitwise,
                       "max_abs_err": {n: c["max_abs_err"] for n, c in checked.items()},
                       "ptxas": {tag: log for tag, (_, log) in built.items()}}, fh, indent=1)
    print(json.dumps({"sums": sums, "bitwise_equal_to_reference":
                      None if bitwise is None else all(bitwise.values()),
                      "max_abs_err": max(c["max_abs_err"] for c in checked.values())}))
    print(json.dumps({"ptxas": {tag: log for tag, (_, log) in built.items()}}))
    print(card)


if __name__ == "__main__":
    main()
