"""Milliseconds a solve's host spends blocked on reads of device values
(the program's ``host_wait``, ``utils/tracing.py``: the recorded loop's
flag reads and copies and the factorization's verdict reads), over the
window's solves; nothing where the program does not report it."""


def read(ctx):
    done = ctx["window"]
    if not done or any("host_wait" not in r["timers"] for r in done):
        return None
    return 1e3 * sum(r["timers"]["host_wait"] for r in done) / len(done)
