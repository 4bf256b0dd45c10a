"""Milliseconds a solve spends in ``GPSolver``'s ``factorize`` phase
(its constructor: Gram assembly, nugget, factorization, quality probe),
from the program's own phase timers, over the window's solves."""


def read(ctx):
    done = ctx["window"]
    if not done:
        return None
    return 1e3 * sum(r["timers"].get("factorize", 0.0) for r in done) / len(done)
