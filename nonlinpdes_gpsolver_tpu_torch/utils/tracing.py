"""Spans of one solve on the host clock, and the solver's phase times.

A :class:`Record` holds the spans of one solve. The model constructor
starts it (its ``build`` span, with the record current inside it, so that
the recorded data evaluation adds ``build.record`` and ``build.replay``)
and the problem carries it
(``CollocationProblem.trace``); each :class:`..api.GPSolver` continues a
copy of it, and ``SolveResult`` carries it with its :meth:`Record.timers`.
While a solver factors or solves, its record is the current one (a
``contextvars`` variable), so that code below it adds to it without new
arguments:

* :func:`span` ``(name)``: a span of the current record, its name, start,
  end and parent on the host clock. The record sums each name's seconds
  and its self seconds (less what its child spans and accruals cover)
  when they are read, not while the solve runs.
* :func:`read` ``(convert, value)`` and :func:`waited` ``(t0)``: the
  seconds of each blocking read of a device value added to ``host_wait``;
  :func:`accrue` the same under another name (``gauss_newton.replay`` and
  ``build.replay``, the host's time to queue a recorded graph). Two clock
  reads and no span object, as these sit inside per-iteration loops.
* :meth:`Record.phase` ``(name, device)`` (:func:`phase` for the current
  record): a span that on a CUDA device also records a timing event on
  the caller's stream at its start and at its end. :meth:`Record.timers`
  reads their elapsed time after the solve's one host read, which follows
  every one of them, and hands the events on to later phases. Nothing
  here synchronizes the device.

With no current record a span costs one object and adds to nothing.

:func:`recording` (off by default) also enters every span, current record
or not, into ``torch.profiler.record_function("gp.<name>")``, so that a
profile holds the spans beside the kernels on the device trace's clock
(``gp.extend`` only there). Off, nothing enters the profiler.
"""

from __future__ import annotations

import contextlib
import contextvars
import time
from typing import Dict, Optional

import torch

# The keys of SolveResult.timers. The three phases, and the mesh path's
# ``'normal'`` step pieces ``gauss_newton.normal_state`` (the interior
# blocks of the kernel inverse, once a factorization) and
# ``gauss_newton.normal_step`` (its steps, summed), are their time from
# start to end including the device work they queued (CUDA events on a
# card, the host clock on the CPU); the others are host seconds:
# ``build`` the model constructor's data evaluation, the dotted keys the
# pieces of ``build`` and of the phases (``build.record`` a capture of the
# evaluation, ``build.replay`` the host's time to copy in, replay and
# clone it), ``host_wait`` the blocking reads of device values and
# ``solver_host`` the host seconds inside ``GPSolver(...)`` and
# ``solve(...)`` less their ``host_wait``.
PHASES = ("factorize", "gauss_newton", "posterior_weights")
KEYS = ("build", "build.record", "build.replay", "factorize", "factorize.assemble",
        "factorize.cholesky", "factorize.inverse", "factorize.quality", "factorize.bind",
        "gauss_newton", "gauss_newton.record", "gauss_newton.replay",
        "gauss_newton.normal_state", "gauss_newton.normal_step", "posterior_weights",
        "host_wait", "solver_host")
BUILD = "build"  # the model constructor's span
HOST_WAIT = "host_wait"
SOLVER = "solver"  # the span around GPSolver(...) and solve(...)

_CURRENT: contextvars.ContextVar = contextvars.ContextVar("gp_solve", default=None)
_recording = False
_FREE_EVENTS: Dict[torch.device, list] = {}  # timing events already read, by device

# a span: [name, start, end, parent index (-1: none), seconds accrued
# directly in it, of which host_wait]
_NAME, _START, _END, _PARENT, _ACCRUED, _WAITED = range(6)


class Record:
    """The spans of one solve.

    ``spans`` lists ``[name, start, end, parent, accrued, waited]``
    (``perf_counter`` seconds; ``parent`` the index of the enclosing span,
    -1 for none; ``accrued`` the accruals made directly inside it,
    ``waited`` the ``host_wait`` among them) in the order they opened.
    :attr:`seconds` and :attr:`self_seconds` sum them by name, with the
    accrued names; :attr:`waits_in` gives the ``host_wait`` inside each
    name's spans."""

    __slots__ = ("spans", "accrued", "device_seconds", "_events", "_open")

    def __init__(self):
        self.spans: list = []
        self.accrued: Dict[str, float] = {}
        self.device_seconds: Dict[str, float] = {}
        self._events: list = []  # (phase, device, start event, end event) not yet read
        self._open: list = []  # indices of the open spans

    @classmethod
    def continuing(cls, other: Optional["Record"]) -> "Record":
        """A new record holding what ``other`` (``None``: nothing) has
        so far, to go on alone from there."""
        rec = cls()
        if other is not None:
            rec.spans = [list(s) for s in other.spans]
            rec.accrued = dict(other.accrued)
            rec.device_seconds = dict(other.device_seconds)
        return rec

    def span(self, name: str) -> "_Span":
        return _Span(self, name)

    def solving(self) -> "_Span":
        """The ``solver`` span, with this record current inside it."""
        return _Span(self, SOLVER, current=True)

    def building(self) -> "_Span":
        """The ``build`` span, with this record current inside it."""
        return _Span(self, BUILD, current=True)

    def phase(self, name: str, device) -> "_Span":
        """A span that on a CUDA ``device`` also times the device work it
        queued by two events on the caller's stream."""
        device = torch.device(device)
        return _Span(self, name, device=device if device.type == "cuda" else None)

    def accrue(self, name: str, seconds: float) -> None:
        self.accrued[name] = self.accrued.get(name, 0.0) + seconds
        if self._open:
            span = self.spans[self._open[-1]]
            span[_ACCRUED] += seconds
            if name == HOST_WAIT:
                span[_WAITED] += seconds

    def _sums(self):
        """``(seconds, self seconds, host_wait inside)`` by name, over the
        closed spans and the accruals."""
        seconds, own, waits = dict(self.accrued), dict(self.accrued), {}
        inside = [0.0] * len(self.spans)  # host_wait in each span's subtree
        for i in range(len(self.spans) - 1, -1, -1):  # every child after its parent
            name, start, end, parent, accrued, waited = self.spans[i]
            if end is None:
                continue
            d = end - start
            seconds[name] = seconds.get(name, 0.0) + d
            own[name] = own.get(name, 0.0) + d - accrued
            inside[i] += waited
            waits[name] = waits.get(name, 0.0) + inside[i]
            if parent >= 0:
                pname = self.spans[parent][_NAME]
                own[pname] = own.get(pname, 0.0) - d
                inside[parent] += inside[i]
        return seconds, own, waits

    @property
    def seconds(self) -> Dict[str, float]:
        return self._sums()[0]

    @property
    def self_seconds(self) -> Dict[str, float]:
        return self._sums()[1]

    @property
    def waits_in(self) -> Dict[str, float]:
        return self._sums()[2]

    def timers(self) -> Dict[str, float]:
        """Seconds by :data:`KEYS`, 0 for what did not run. Reads the
        phases' events: call it after a host read that follows them (the
        end event's wait then returns at once)."""
        for name, device, start, end in self._events:
            end.synchronize()
            self.device_seconds[name] = (self.device_seconds.get(name, 0.0)
                                         + start.elapsed_time(end) / 1e3)
            _FREE_EVENTS.setdefault(device, []).extend((start, end))
        self._events.clear()
        seconds, _, waits = self._sums()
        out = {k: seconds.get(k, 0.0) for k in KEYS}
        out.update(self.device_seconds)
        out["solver_host"] = seconds.get(SOLVER, 0.0) - waits.get(SOLVER, 0.0)
        return out


def _event(device) -> "torch.cuda.Event":
    free = _FREE_EVENTS.get(device)
    return free.pop() if free else torch.cuda.Event(enable_timing=True)


class _Span:
    """A span of ``rec`` (``None``: of no record), see :class:`Record`."""

    __slots__ = ("rec", "name", "device", "current", "_token", "_rf", "_stream", "_start")

    def __init__(self, rec: Optional[Record], name: str, device=None, current: bool = False):
        self.rec, self.name, self.device, self.current = rec, name, device, current
        self._rf = None

    def __enter__(self):
        rec = self.rec
        if self.current:
            self._token = _CURRENT.set(rec)
        if _recording:
            self._rf = torch.profiler.record_function("gp." + self.name)
            self._rf.__enter__()
        if rec is not None:
            opened, spans = rec._open, rec.spans
            parent = opened[-1] if opened else -1
            opened.append(len(spans))
            spans.append([self.name, time.perf_counter(), None, parent, 0.0, 0.0])
            if self.device is not None:
                self._stream = torch.cuda.current_stream(self.device)
                self._start = _event(self.device)
                self._start.record(self._stream)
        return self

    def __exit__(self, *exc):
        rec = self.rec
        if rec is not None:
            if self.device is not None:
                end = _event(self.device)
                end.record(self._stream)
                rec._events.append((self.name, self.device, self._start, end))
            rec.spans[rec._open.pop()][_END] = time.perf_counter()
        if self._rf is not None:
            self._rf.__exit__(*exc)
            self._rf = None
        if self.current:
            _CURRENT.reset(self._token)
        return False


def current() -> Optional[Record]:
    """The record of the solve in progress, or ``None``."""
    return _CURRENT.get()


def span(name: str) -> _Span:
    """A span of the current record."""
    return _Span(_CURRENT.get(), name)


def phase(name: str, device) -> _Span:
    """A phase (:meth:`Record.phase`) of the current record: on a CUDA
    ``device`` two timing events, summed over every such phase of one
    name."""
    rec = _CURRENT.get()
    return rec.phase(name, device) if rec is not None else _Span(None, name)


def accrue(name: str, t0: float) -> None:
    """Add the seconds since ``t0`` (``time.perf_counter``) to ``name`` of
    the current record."""
    rec = _CURRENT.get()
    if rec is not None:
        rec.accrue(name, time.perf_counter() - t0)


def waited(t0: float) -> None:
    """A blocking read of a device value that began at ``t0`` is done."""
    accrue(HOST_WAIT, t0)


def read(convert, value):
    """``convert(value)`` (``bool``, ``float``), a blocking read of the
    device tensor ``value``, its wait added to ``host_wait``."""
    t0 = time.perf_counter()
    out = convert(value)
    accrue(HOST_WAIT, t0)
    return out


@contextlib.contextmanager
def recording():
    """Within the block every span also enters the profiler as
    ``gp.<name>`` (``torch.profiler.record_function``): its host range,
    and under a CUDA profiler a device-side mirror over the kernels it
    launched."""
    global _recording
    prev, _recording = _recording, True
    try:
        yield
    finally:
        _recording = prev
