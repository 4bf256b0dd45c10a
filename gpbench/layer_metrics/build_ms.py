"""Milliseconds a solve spends building its problem: the program's
``build`` span (the model constructor's data evaluation,
``utils/tracing.py``), host seconds over the window's solves; nothing
where the program has no such span."""


def read(ctx):
    done = ctx["window"]
    if not done or any("build" not in r["timers"] for r in done):
        return None
    return 1e3 * sum(r["timers"]["build"] for r in done) / len(done)
