"""Inner conjugate-gradient iterations a solve (the sum of
``GNState.cg_iters``), over the window; nothing where no step is Krylov."""


def read(ctx):
    done = ctx["window"]
    total = sum(r["cg_iters"] for r in done)
    return total / len(done) if done and total else None
