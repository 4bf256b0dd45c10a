"""The share of the run's ``'normal'`` states (the interior blocks of the
kernel inverse, once a factorization; warm-up, window and traced solves)
that the program computed in ``potri``'s order, from the interior columns
of the factor's inverse and one symmetric product: its counter of states by
route (``ops/graphs.py::NORMAL_STATES``), read when the metric is read;
nothing where the program has no such counter or computed no such state."""


def read(ctx):
    from nonlinpdes_gpsolver_tpu_torch.ops import graphs

    counts = getattr(graphs, "NORMAL_STATES", None)
    if not counts or not sum(counts.values()):
        return None
    return counts.get("potri", 0) / sum(counts.values())
