"""GiB the reuse layer keeps of released entries at the window's end
(``ops/graphs.py::RETAINED_BYTES``)."""


def read(ctx):
    return ctx["retained_bytes"] / 2**30
