"""K2's share of its roofline: the least time for each block's equilibrated
Gram matrix, its lower triangle written once, at the card's peaks
(``frozen/roofline.py``, from the problem's shapes), over the traced time
of every ``gram_equilibrated_kernel`` launch."""

from gpbench.frozen.roofline import least_seconds
from gpbench.trace import seconds_matching


def read(ctx):
    t, work = ctx["trace"], ctx["work"].get("k2")
    spent = seconds_matching(t, "gram_equilibrated_kernel") if t else 0.0
    if not spent or work is None:
        return None
    bound, _ = least_seconds(work, ctx["dtype"])
    return 100.0 * bound / spent
