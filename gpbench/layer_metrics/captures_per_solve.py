"""CUDA graphs recorded a solve (``ops/graphs.py::CAPTURES``), over the
window: 0 once the reuse of the recorded loop holds."""


def read(ctx):
    n = ctx["solves"]
    return ctx["counters"]["CAPTURES"] / n if n else None
