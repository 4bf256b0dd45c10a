"""Milliseconds a solve spends computing the ``'normal'`` step's state: the
interior blocks of the kernel inverse, once a factorization (the
program's ``gauss_newton.normal_state``, timed by CUDA events,
``utils/tracing.py``), over the window's solves; nothing where the program
has no such key."""


def read(ctx):
    done = ctx["window"]
    if not done or any("gauss_newton.normal_state" not in r["timers"] for r in done):
        return None
    return 1e3 * sum(r["timers"]["gauss_newton.normal_state"] for r in done) / len(done)
