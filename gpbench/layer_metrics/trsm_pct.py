"""Per cent of the traced device time spent in kernels whose name holds
``trsm`` (cuBLAS triangular solves)."""

from gpbench.trace import seconds_matching


def read(ctx):
    t = ctx["trace"]
    if not t or not t["device_s"]:
        return None
    return 100.0 * seconds_matching(t, "trsm") / t["device_s"]
