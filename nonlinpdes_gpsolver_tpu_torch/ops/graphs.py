"""Capture and replay of the Gauss-Newton loop as CUDA graphs.

The port's counterpart of ``jax.jit`` for the loop. The JAX package runs
the whole Gauss-Newton loop as one compiled executable
(``solvers/gn.py::_gn_scan`` there); here a step is a function of tensors
that keep their storage (the loop's state), recorded once as CUDA graphs
and replayed, so that a step costs one launch a graph instead of hundreds
of small dispatches from Python.

* :class:`Recorder` owns a memory pool, on its device's one capture
  stream. Its graphs share the pool (a Krylov step is three graphs: the
  set-up, one CG iteration and the update, replayed in that order), and
  its ``scope`` runs the eager warm-up and the replays on the capture
  stream. On the CPU (and inside :func:`uncaptured`) it records nothing
  and every part runs directly.
* :class:`Flag` is a device flag the host reads one launch late: it is
  copied to pinned memory behind the launch that sets it, and read after
  the next launch is queued, so that the card never waits on the host.
  The CG loop's exit test reads it once an iteration.

A capture that fails raises: there is no return to an eager loop.
Counters for the chip smoke test: ``CAPTURES``, ``CAPTURE_SECONDS``,
``REPLAYS`` and ``HOST_READS`` (the lagged flag reads and the end-of-loop
copies); and those of the loops shared by problems of one structure
(``solvers/_reuse.py``): ``ENTRIES`` (entries made), ``REBINDS`` (problems
whose factorization wrote into a released entry's storage), ``UNSHARED``
(problems without a layout key, left on loops of their own), ``GUESTS``
(problems served by their layout's guest entry), ``GUEST_LOADS`` (copies
of a guest's factors into the guest entry) and ``RETAINED_BYTES`` (the factor, data and graph-pool bytes that
released entries keep; a gauge, not reset). :func:`reset_counts` zeroes the others.

The current solve's record (``utils/tracing.py``) takes a capture's span
``gauss_newton.record``, the host's time to queue replays
(``gauss_newton.replay``) and the waits of the flag reads and copies
(``host_wait``).
"""

from __future__ import annotations

import contextlib
import time
from typing import Callable, Dict

import torch

from ..utils import tracing

CAPTURES = 0
CAPTURE_SECONDS = 0.0
REPLAYS = 0
HOST_READS = 0
ENTRIES = 0
REBINDS = 0
UNSHARED = 0
GUESTS = 0
GUEST_LOADS = 0
RETAINED_BYTES = 0

_enabled = True
capturing = False  # a capture is in progress (no graph may be freed meanwhile)


def reset_counts() -> None:
    global CAPTURES, CAPTURE_SECONDS, REPLAYS, HOST_READS, ENTRIES, REBINDS, UNSHARED
    global GUESTS, GUEST_LOADS
    CAPTURES, CAPTURE_SECONDS, REPLAYS, HOST_READS = 0, 0.0, 0, 0
    ENTRIES, REBINDS, UNSHARED, GUESTS, GUEST_LOADS = 0, 0, 0, 0, 0


@contextlib.contextmanager
def uncaptured():
    """Within the block, loops on the card run their steps eagerly: the
    same functions, neither recorded nor replayed (the reference a replay
    is held to)."""
    global _enabled
    prev, _enabled = _enabled, False
    try:
        yield
    finally:
        _enabled = prev


_STREAMS: Dict[torch.device, "torch.cuda.Stream"] = {}


def _capture_stream(device) -> "torch.cuda.Stream":
    """The one capture stream of ``device``: the libraries keep a handle
    and a workspace for each stream they meet, so every recorder of a
    device shares one."""
    device = torch.device(device)
    if device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    stream = _STREAMS.get(device)
    if stream is None:
        stream = _STREAMS[device] = torch.cuda.Stream(device)
    return stream


class Recorder:
    """Graphs recorded into one memory pool, on the device's capture stream.

    ``capture(name, fn)`` records ``fn()`` (which reads and writes tensors
    that outlive it) as graph ``name``; ``replay(name)`` replays it.
    ``live`` says whether this call may record and replay: on a CUDA card,
    outside :func:`uncaptured`. ``scope()`` puts a live caller on the
    capture stream (ordered after the caller's stream, which waits for it
    at the end): the eager warm-up must run there, so that the libraries'
    per-stream handles and workspaces exist before the capture. ``pool``
    shares a pool with other recorders (graphs that are never replayed
    concurrently, each of whose lasting tensors is rewritten by its own
    replays)."""

    def __init__(self, device, capture: bool = True, pool=None):
        self.device = torch.device(device)
        self.capture_on = bool(capture) and self.device.type == "cuda"
        self.graphs: Dict[str, "torch.cuda.CUDAGraph"] = {}
        if self.capture_on:
            self.stream = _capture_stream(self.device)
            self.pool = torch.cuda.graph_pool_handle() if pool is None else pool

    @property
    def live(self) -> bool:
        return self.capture_on and _enabled

    @contextlib.contextmanager
    def scope(self):
        if self.device.type != "cuda":
            yield
            return
        caller = torch.cuda.current_stream(self.device)
        stream = self.stream if self.live else caller
        stream.wait_stream(caller)
        with torch.cuda.stream(stream):
            yield
        caller.wait_stream(stream)

    @property
    def captured(self) -> bool:
        return bool(self.graphs)

    def capture(self, name: str, fn: Callable[[], None]) -> None:
        global CAPTURES, CAPTURE_SECONDS, capturing
        t0 = time.perf_counter()
        graph = torch.cuda.CUDAGraph()
        capturing = True
        try:
            with tracing.span("gauss_newton.record"), torch.cuda.stream(self.stream):
                # thread-local: another thread's queries (a process group's
                # watchdog polling its events) do not void the capture
                graph.capture_begin(pool=self.pool, capture_error_mode="thread_local")
                try:
                    fn()
                except BaseException:
                    with contextlib.suppress(Exception):
                        graph.capture_end()
                    raise
                graph.capture_end()
        finally:
            capturing = False
        self.graphs[name] = graph
        CAPTURES += 1
        CAPTURE_SECONDS += time.perf_counter() - t0

    def replay(self, name: str) -> None:
        global REPLAYS
        t0 = time.perf_counter()
        self.graphs[name].replay()
        tracing.accrue("gauss_newton.replay", t0)
        REPLAYS += 1


class Flag:
    """A device flag read on the host one launch late.

    ``post(flag)`` snapshots the 0-dim tensor ``flag`` (a bool or a small
    integer) behind the work
    queued so far (on the card: an asynchronous copy to pinned memory and
    an event); ``read()`` waits for that snapshot only and returns it. Post,
    queue the next launch, then read: the card never idles for the read.
    """

    def __init__(self, device):
        self.cuda = torch.device(device).type == "cuda"
        if self.cuda:
            self.host = torch.empty((), dtype=torch.int64, pin_memory=True)
            self.event = torch.cuda.Event()
        self.value = None

    def post(self, flag: torch.Tensor) -> None:
        if self.cuda:
            self.host.copy_(flag, non_blocking=True)
            self.event.record()
        else:
            self.value = flag.clone()

    def read(self) -> int:
        global HOST_READS
        HOST_READS += 1
        if self.cuda:
            t0 = time.perf_counter()
            self.event.synchronize()
            tracing.waited(t0)
            return int(self.host.item())
        return int(self.value.item())


def to_host(t: torch.Tensor) -> torch.Tensor:
    """A CPU copy of ``t`` (one read: on the card through pinned memory and
    an event, not a stream synchronization)."""
    global HOST_READS
    if t.device.type != "cuda":
        return t.clone()
    HOST_READS += 1
    out = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    out.copy_(t, non_blocking=True)
    ev = torch.cuda.Event()
    ev.record()
    t0 = time.perf_counter()
    ev.synchronize()
    tracing.waited(t0)
    return out
