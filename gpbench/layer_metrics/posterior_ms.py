"""Milliseconds a solve spends on the posterior: the program's
``posterior_weights`` phase plus the harness's ``extend`` call on the test
points, synchronized before and after, over the window's solves."""


def read(ctx):
    done = ctx["window"]
    if not done:
        return None
    return 1e3 * sum(r["timers"].get("posterior_weights", 0.0) + r["extend_s"]
                     for r in done) / len(done)
