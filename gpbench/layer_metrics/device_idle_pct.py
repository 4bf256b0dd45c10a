"""Per cent of the traced window in which no device activity ran:
``100 (1 - busy / window)``, busy the union of every kernel, graph-replayed
kernel, copy and set interval."""


def read(ctx):
    t = ctx["trace"]
    if not t or not t["activities"]:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
