"""Milliseconds a solve spends in the Gauss-Newton loop (the program's
``gauss_newton`` phase timer), over the window's solves."""


def read(ctx):
    done = ctx["window"]
    if not done:
        return None
    return 1e3 * sum(r["timers"].get("gauss_newton", 0.0) for r in done) / len(done)
