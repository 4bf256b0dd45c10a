"""Milliseconds of the solver's host path a solve: the host seconds inside
``GPSolver(...)`` and ``solve(...)`` less the host's waits on the device
in them (the program's ``solver_host``, ``utils/tracing.py``), over the
window's solves; nothing where the program does not report it."""


def read(ctx):
    done = ctx["window"]
    if not done or any("solver_host" not in r["timers"] for r in done):
        return None
    return 1e3 * sum(r["timers"]["solver_host"] for r in done) / len(done)
