"""Compare the numerics of two ``chip_smoke.py`` logs, phase by phase.

    python3 scripts/torch_smoke_diff.py OLD.log NEW.log [--keys test_l2 rungs ...]

Each log is ``chip_smoke.py``'s standard output: one JSON line a phase.
Every value under one of ``--keys`` (by default the accuracy metrics, the
escalation rungs, the kernel launch counts, the loss histories and the CG
iteration counts), at a path that both logs hold (the n-th line of a phase
name, then the keys and list indices inside it), is compared as printed.
Prints the number of values compared and each path whose value differs;
exits 1 if any does. Paths that only one log holds (a phase or a case one
version adds) are counted apart and not compared.
"""

from __future__ import annotations

import argparse
import json
import sys
from collections import Counter

KEYS = ("test_l2", "test_linf", "l2", "linf", "a_rel_l2", "u_l2", "rungs", "k1_launches",
        "k2_launches", "launches", "losses", "cg_iters", "cg_iterations", "step_solver")


def phases(path):
    """``{(phase, n): line}`` of a log's JSON phase lines."""
    out, seen = {}, Counter()
    with open(path) as fh:
        for raw in fh:
            raw = raw.strip()
            if not raw.startswith("{"):
                continue
            try:
                line = json.loads(raw)
            except json.JSONDecodeError:
                continue
            if isinstance(line, dict) and "phase" in line:
                name = line["phase"]
                out[(name, seen[name])] = line
                seen[name] += 1
    return out


def leaves(obj, keys, path=(), under=False):
    """``(path, value)`` of every value at or below one of ``keys``."""
    if isinstance(obj, dict):
        for k, v in obj.items():
            yield from leaves(v, keys, path + (k,), under or k in keys)
    elif isinstance(obj, list):
        for i, v in enumerate(obj):
            yield from leaves(v, keys, path + (i,), under)
    elif under:
        yield path, obj


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("old")
    ap.add_argument("new")
    ap.add_argument("--keys", nargs="+", default=list(KEYS))
    args = ap.parse_args()
    old, new = phases(args.old), phases(args.new)
    keys = set(args.keys)
    a = {(p,) + k: v for p, line in old.items() for k, v in leaves(line, keys)}
    b = {(p,) + k: v for p, line in new.items() for k, v in leaves(line, keys)}
    both = sorted(set(a) & set(b), key=str)
    differ = [k for k in both if a[k] != b[k]]
    for k in differ:
        print(f"differs: {k}: {a[k]!r} -> {b[k]!r}")
    print(json.dumps({"compared": len(both), "differ": len(differ),
                      "only_old": len(set(a) - set(b)), "only_new": len(set(b) - set(a))}))
    sys.exit(1 if differ else 0)


if __name__ == "__main__":
    main()
