"""Host reads of device values a solve, by the recorded loop's counter
(``ops/graphs.py::HOST_READS``), over the window."""


def read(ctx):
    n = ctx["solves"]
    return ctx["counters"]["HOST_READS"] / n if n else None
