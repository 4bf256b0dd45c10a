"""Capture and replay of the Gauss-Newton loop, and of the models' data
evaluation, as CUDA graphs.

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

:func:`evaluated` is the counterpart of the JAX package's one
``jax.jit(jax.vmap(fn))`` per user data callable
(``models/elliptic.py::_vmapped_jit`` there): a model constructor's
evaluation of a callable at its points, recorded once per (key, shape,
strides, dtype, device) and replayed on every later build. Its first call
evaluates eagerly (the answer), records, replays once and holds the replay
to the eager result bitwise (one host read, once per key); a capture that
raises, an output off the points' device or a replay that differs leaves
the key eager for good. Later calls copy the points into the recording's
input, replay and clone its output: queued, nothing read.

Counters for the chip smoke test: ``CAPTURES``, ``CAPTURE_SECONDS``,
``REPLAYS`` and ``HOST_READS`` (the lagged flag reads and the end-of-loop
copies); and those of the loops shared by problems of one structure
(``solvers/_reuse.py``): ``ENTRIES`` (entries made), ``REBINDS`` (problems
whose factorization wrote into a released entry's storage), ``UNSHARED``
(problems without a layout key, left on loops of their own), ``GUESTS``
(problems served by their layout's guest entry), ``GUEST_LOADS`` (copies
of a guest's factors into the guest entry) and ``RETAINED_BYTES`` (the factor, data and graph-pool bytes that
released entries keep; a gauge, not reset); and the data evaluation's
``EVAL_CAPTURES``, ``EVAL_REPLAYS`` and ``EVAL_EAGER`` (keys left eager);
and ``STEP_SOLVERS``, the Gauss-Newton loops run by the step solver they
were routed to (:func:`routed`); and ``TRSM_ROUTES``, the P = 1 triangular
solves issued from Python (eager or being recorded; a replay is not
counted) by the route they took, ``"kernel"`` (``ops/trsm_rowblock.py``) or
``"library"`` (``torch.linalg.solve_triangular``) (:func:`trsm_routed`);
and ``NORMAL_STATES``, the ``'normal'`` step's states computed (the
interior blocks of the kernel inverse, once a factorization), by route:
``"potri"`` (P = 1: the triangular inverse's interior columns and one
symmetric product) or ``"solves"`` (across ranks: column-sharded kernel
solves) (:func:`normal_state_routed`).
:func:`reset_counts` zeroes all but ``RETAINED_BYTES``.

The current solve's record (``utils/tracing.py``) takes a capture's span
``gauss_newton.record``, the host's time to queue replays
(``gauss_newton.replay``) and the waits of the flag reads and copies
(``host_wait``); the constructor's record takes an evaluation's capture
(``build.record``) and the host's time to copy in, replay and clone it
(``build.replay``).
"""

from __future__ import annotations

import contextlib
import time
from collections import OrderedDict
from typing import Callable, Dict, Hashable

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
EVAL_CAPTURES = 0
EVAL_REPLAYS = 0
EVAL_EAGER = 0
STEP_SOLVERS: Dict[str, int] = {}
TRSM_ROUTES: Dict[str, int] = {"kernel": 0, "library": 0}
NORMAL_STATES: Dict[str, int] = {"potri": 0, "solves": 0}

_enabled = True
capturing = False  # a capture is in progress (no graph may be freed meanwhile)


def reset_counts() -> None:
    global CAPTURES, CAPTURE_SECONDS, REPLAYS, HOST_READS, ENTRIES, REBINDS, UNSHARED
    global GUESTS, GUEST_LOADS, EVAL_CAPTURES, EVAL_REPLAYS, EVAL_EAGER
    CAPTURES, CAPTURE_SECONDS, REPLAYS, HOST_READS = 0, 0.0, 0, 0
    ENTRIES, REBINDS, UNSHARED, GUESTS, GUEST_LOADS = 0, 0, 0, 0, 0
    EVAL_CAPTURES, EVAL_REPLAYS, EVAL_EAGER = 0, 0, 0
    STEP_SOLVERS.clear()
    TRSM_ROUTES.update(kernel=0, library=0)
    NORMAL_STATES.update(potri=0, solves=0)


def routed(step_solver: str) -> None:
    """Count a Gauss-Newton loop run by ``step_solver``."""
    STEP_SOLVERS[step_solver] = STEP_SOLVERS.get(step_solver, 0) + 1


def trsm_routed(route: str) -> None:
    """Count a P = 1 triangular solve that took ``route``."""
    TRSM_ROUTES[route] += 1


def normal_state_routed(route: str) -> None:
    """Count a ``'normal'`` state computed by ``route``."""
    NORMAL_STATES[route] += 1


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


def _record(stream, pool, span: str, fn: Callable[[], None]) -> "torch.cuda.CUDAGraph":
    """``fn()`` recorded as a graph into ``pool`` on ``stream``, inside the
    current record's span ``span``; raises what the capture raises."""
    global capturing
    graph = torch.cuda.CUDAGraph()
    capturing = True
    try:
        with tracing.span(span), torch.cuda.stream(stream):
            # thread-local: another thread's queries (a process group's
            # watchdog polling its events) do not void the capture
            graph.capture_begin(pool=pool, capture_error_mode="thread_local")
            try:
                fn()
            except BaseException:
                with contextlib.suppress(Exception):
                    graph.capture_end()
                raise
            graph.capture_end()
    finally:
        capturing = False
    return graph


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
        global CAPTURES, CAPTURE_SECONDS
        t0 = time.perf_counter()
        self.graphs[name] = _record(self.stream, self.pool, "gauss_newton.record", fn)
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


EVAL_LIMIT = 64  # recorded evaluations kept, least recently used dropped first
_EVALS: "OrderedDict[tuple, _Evaluation]" = OrderedDict()
_EVAL_POOLS: Dict[torch.device, tuple] = {}


def records_on(device) -> bool:
    """Whether an evaluation on ``device`` is recorded: on a CUDA card,
    outside :func:`uncaptured`."""
    return torch.device(device).type == "cuda" and _enabled


def _same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    """``a`` and ``b`` hold the same bits (one host read)."""
    if a.shape != b.shape or a.dtype != b.dtype or a.device != b.device:
        return False
    a, b = a.contiguous(), b.contiguous()
    ints = {2: torch.int16, 4: torch.int32, 8: torch.int64}.get(a.element_size())
    if a.is_floating_point() and ints is not None:
        a, b = a.view(ints), b.view(ints)  # NaN payloads and signed zeros compared too
    t0 = time.perf_counter()
    same = torch.equal(a, b)
    tracing.waited(t0)
    return same


class _Evaluation:
    """One evaluation's recording: its graph (``None``: the key stays
    eager, ``why`` says why), its input ``x`` (outside the pool, so that
    it outlives any other graph's replay), its output ``out`` (in the pool)
    and ``held``, the objects its key names by identity, kept alive with it
    so that no live key's ``id`` is reused."""

    __slots__ = ("graph", "x", "out", "held", "why")

    def __init__(self, held: tuple):
        self.graph = self.x = self.out = None
        self.held = held
        self.why = ""

    def record(self, compute: Callable[[torch.Tensor], torch.Tensor], X: torch.Tensor,
               eager: torch.Tensor) -> None:
        """Record ``compute`` at ``X``, whose eager result is ``eager``, or
        leave the key eager."""
        global EVAL_CAPTURES, EVAL_EAGER
        try:
            if not isinstance(eager, torch.Tensor) or eager.device != X.device:
                raise ValueError("the output is not a tensor on the points' device")
            self.graph = self._capture(compute, X)
            if not _same_bits(self.out, eager):
                raise ValueError("the replay differs from the eager evaluation")
        # the recording is an optimisation of an evaluation that already
        # succeeded: whatever stops it (a host read, RNG or numpy inside the
        # callable) leaves the key eager, and the reason on the entry
        except Exception as exc:  # noqa: BLE001
            self.graph = self.x = self.out = None
            self.why = f"{type(exc).__name__}: {exc}"
            EVAL_EAGER += 1
            return
        EVAL_CAPTURES += 1

    def _capture(self, compute, X: torch.Tensor) -> "torch.cuda.CUDAGraph":
        caller = torch.cuda.current_stream(X.device)
        stream = _capture_stream(X.device)
        self.x = torch.empty_strided(X.shape, X.stride(), dtype=X.dtype, device=X.device)
        self.x.copy_(X)
        stream.wait_stream(caller)
        try:
            with torch.cuda.stream(stream):
                compute(self.x)  # the libraries' handles for this stream, before the capture

                def body():
                    self.out = compute(self.x)

                graph = _record(stream, _eval_pool(X.device), "build.record", body)
                graph.replay()
        finally:
            caller.wait_stream(stream)
        return graph

    def replay(self, X: torch.Tensor) -> torch.Tensor:
        global EVAL_REPLAYS
        t0 = time.perf_counter()
        # Every evaluation graph of a device shares one pool, so a replay
        # may overwrite another graph's output. That is safe: all of them
        # replay on the one capture stream, each after the caller's stream
        # (so after the clone of the previous replay's output), the inputs
        # live outside the pool, and each output is cloned on the caller's
        # stream before any other evaluation is queued.
        caller = torch.cuda.current_stream(X.device)
        stream = _capture_stream(X.device)
        self.x.copy_(X)
        stream.wait_stream(caller)
        with torch.cuda.stream(stream):
            self.graph.replay()
        caller.wait_stream(stream)
        out = self.out.clone()
        tracing.accrue("build.replay", t0)
        EVAL_REPLAYS += 1
        return out


def _eval_pool(device) -> tuple:
    """The pool of ``device``'s evaluation graphs: a new one while no
    recorded evaluation holds the last (the allocator takes no capture into
    a pool whose graphs are all gone)."""
    if not any(e.graph is not None and e.x.device == device for e in _EVALS.values()):
        _EVAL_POOLS[device] = torch.cuda.graph_pool_handle()
    return _EVAL_POOLS[device]


def evaluated(compute: Callable[[torch.Tensor], torch.Tensor], X: torch.Tensor,
              key: Hashable, held: tuple) -> torch.Tensor:
    """``compute(X)`` on a CUDA card: eager and recorded at the first call
    for ``key`` at ``X``'s shape, strides, dtype and device, replayed from
    the second. ``key`` names what ``compute`` computes; ``held`` are the
    objects it names by identity (kept with the recording)."""
    full = (key, tuple(X.shape), X.stride(), X.dtype, X.device)
    entry = _EVALS.get(full)
    if entry is not None:
        _EVALS.move_to_end(full)
        return compute(X) if entry.graph is None else entry.replay(X)
    out = compute(X)
    entry = _EVALS[full] = _Evaluation(held)
    entry.record(compute, X, out)
    while len(_EVALS) > EVAL_LIMIT:
        _EVALS.popitem(last=False)
    return out


def clear_evaluations() -> None:
    """Drop every recorded evaluation (its graph, input, output and held
    objects)."""
    _EVALS.clear()
