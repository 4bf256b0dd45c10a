"""The share of the run's P = 1 triangular solves (warm-up, window and
traced solves) that the program routed to its row-block kernel: its counter
of solves by route (``ops/graphs.py::TRSM_ROUTES``), read when the metric is
read; nothing where the program has no such counter or made no such solve."""


def read(ctx):
    from nonlinpdes_gpsolver_tpu_torch.ops import graphs

    counts = getattr(graphs, "TRSM_ROUTES", None)
    if not counts or not sum(counts.values()):
        return None
    return counts.get("kernel", 0) / sum(counts.values())
