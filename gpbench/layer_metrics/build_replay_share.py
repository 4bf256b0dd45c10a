"""The share of the window's solves whose problem construction replayed a
recorded data evaluation: the program's ``build.replay`` (host seconds to
copy in, replay and clone the recorded ``vmap`` of a data callable,
``utils/tracing.py``) above zero; nothing where the program has no such
key."""


def read(ctx):
    done = ctx["window"]
    if not done or any("build.replay" not in r["timers"] for r in done):
        return None
    return sum(r["timers"]["build.replay"] > 0.0 for r in done) / len(done)
