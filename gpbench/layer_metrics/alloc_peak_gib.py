"""The allocator's peak over the window, GiB
(``torch.cuda.max_memory_allocated`` after a reset at its start)."""


def read(ctx):
    return ctx["alloc_peak_bytes"] / 2**30 if ctx["alloc_peak_bytes"] else None
