"""A time limit for each of the port's tests: :data:`TEST_SECONDS`.

Every ``tests/test_torch_*.py`` imports the autouse fixture
:func:`time_limit` (``from torch_time_limit import time_limit  # noqa:
F401``), which puts the test's function fixtures and its call under the
limit. A module fixture is set up before any function fixture, so one that
does heavy work runs its body under :func:`limited` itself. Past the limit
the stacks of every thread are printed and the test fails, and the run goes
on with the next one. Every subprocess and notebook the port's tests start
is given a timeout no larger than the limit (``tests/test_torch_test_budget.py``).

The limit acts on Linux, in the main thread (``signal.alarm``); elsewhere
the tests run without it. It imports neither jax nor torch.
"""

import contextlib
import faulthandler
import signal
import sys
import threading

import pytest

# The port's slowest item, tests/test_torch_ranks.py's module fixture, took
# 145-172 s beside five other test workers on an 8-core host; its own wait
# for the rank workers (WORKER_SECONDS there) and their stopping fit inside.
TEST_SECONDS = 600


@contextlib.contextmanager
def limited(what):
    """Run the body under :data:`TEST_SECONDS`; ``what`` names it in the failure."""
    if not hasattr(signal, "SIGALRM") or threading.current_thread() is not threading.main_thread():
        yield
        return

    def on_alarm(signum, frame):
        faulthandler.dump_traceback(file=sys.__stderr__)
        pytest.fail(f"{what}: over the time limit of {TEST_SECONDS} s (tests/torch_time_limit.py)")

    previous = signal.signal(signal.SIGALRM, on_alarm)
    # the alarm's handler runs once the main thread is back in Python: if it is
    # not a minute later (stuck in native code), the stacks are printed anyway
    faulthandler.dump_traceback_later(TEST_SECONDS + 60, file=sys.__stderr__)
    signal.alarm(TEST_SECONDS)
    try:
        yield
    finally:
        signal.alarm(0)
        faulthandler.cancel_dump_traceback_later()
        signal.signal(signal.SIGALRM, signal.SIG_DFL if previous is None else previous)


@pytest.fixture(autouse=True)
def time_limit(request):
    with limited(request.node.nodeid):
        yield
