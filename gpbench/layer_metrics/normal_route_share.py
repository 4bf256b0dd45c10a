"""The share of the run's Gauss-Newton loops (warm-up, window and traced
solves) that the program routed to the ``'normal'`` step: its counter of
loops by step solver (``ops/graphs.py::STEP_SOLVERS``), read when the
metric is read; nothing where the program has no such counter or ran no
loop."""


def read(ctx):
    from nonlinpdes_gpsolver_tpu_torch.ops import graphs

    counts = getattr(graphs, "STEP_SOLVERS", None)
    if not counts:
        return None
    return counts.get("normal", 0) / sum(counts.values())
