"""Milliseconds a solve spends in its ``'normal'`` Gauss-Newton steps, all
of them: each step's contraction of the inverse blocks, its normal-matrix
solve and its update (the program's ``gauss_newton.normal_step``, summed
over the steps and timed by CUDA events, ``utils/tracing.py``), over the
window's solves; nothing where the program has no such key."""


def read(ctx):
    done = ctx["window"]
    if not done or any("gauss_newton.normal_step" not in r["timers"] for r in done):
        return None
    return 1e3 * sum(r["timers"]["gauss_newton.normal_step"] for r in done) / len(done)
