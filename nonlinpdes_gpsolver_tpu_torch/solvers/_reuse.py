"""Gauss-Newton loops shared by every problem of one structure.

The JAX package compiles its Gauss-Newton loop once per problem
*structure* (``solvers/gn.py::_gn_scan`` there takes the factors and data
as arguments and is keyed on the residual functions, the misfit weights
and the static options), so a problem rebuilt on fresh points and data
reuses the executable, whether or not another problem of that structure is
still alive. The port's counterpart of that executable is a loop recorded
as CUDA graphs (``gn.py::_Loop``), and a recorded graph reads fixed
storage. So the storage goes with the loop: an :class:`Entry` owns

* the storage its graphs read: each block's factor, whitening operator and
  column scales (the mesh path: the rank's factor rows, the diagonal-block
  inverses and the column scales), and its own copy of each ``data`` leaf;
* its loops, one per *loop key* (the routed step solver and the static
  options), sharing the entry's graph memory pool;
* a weak reference to the factored problem *bound* to it, whose factors
  are that storage.

The **layout key** (:func:`layout_key`) is what fixes that storage: per
block its name, its residual function and the shapes of its stored
tensors (which also say whether it whitens through an explicit inverse and
whether it is equilibrated); per misfit its function and weight
(``sqrt(weight)`` is recorded into the graph); each data leaf's name, shape
and dtype; the latent size, the dtype and the device; on the mesh path the
mesh (its size and this rank), the row block and the padded size. Points
and kernels are in neither key: they act only through the factors. Model
constructors build their residuals with ``lru_cache``'d factories, so one
configuration gives one key.

Binding: each live problem of a layout has an entry of its own, up to
two of them. A factorization first claims (:func:`claimed`) a *free*
entry of its layout, one whose bound problem is gone and whose storage
nothing outside the entry still holds; among several it takes the one
bound most recently, whose loops are the furthest recorded. The
factorization then writes its outputs straight into that storage (no
second copy of a factor is ever resident) and the new problem binds
(``REBINDS``). Without a free entry, and while fewer than two entries of
the layout are bound to live problems, the problem's own tensors become a
new entry of the layout (``ENTRIES``): two live problems never read each
other's factors, and each reads its own. Only a problem without a layout
key keeps loops of its own in ``fp.graphs`` (``UNSHARED``): an
unhashable residual, data that is not a dict of tensors, or gloo ranks
that share a card, whose loop is not recorded.

Guests: a problem that would make a third live entry of its layout
becomes a *guest* instead (``GUESTS``, :class:`Guest`). It keeps its own
factors, and its solves run the loops of the layout's one *guest entry*,
made at the first guest solve by the factorization's own storage
constructor (so that its strides, offsets and the one buffer of a factor
and its whitening operator are a factorization's, and its loops compute
the bits a factorization's entry would). Before a guest's solve its
stored tensors are copied into the guest entry on the stream
(``GUEST_LOADS``), unless the entry holds that guest already, and the
loops' per-problem state is computed again. The guest entry is bound to
its guests: it is released only once none of them is alive, so no
factorization claims it before. Why two: a loop that keeps its last
result while the next problem factors (``res = GPSolver(p).solve()``)
holds two live problems at once, and two entries serve it with no copy. A
caller that keeps a third keeps its results (a sweep), where an entry per
problem would be used once: its exact loop never recorded (it records at
its second call), a graph pool and a copy of the data kept per result.
The JAX package serves every live problem of a structure from one
executable; the guest entry does the same at the cost of one copy of the
guest's factors per change of guest, bandwidth-bound.

Across ranks every rank keeps its own entries, and the ranks agree on the
entry a factorization takes (:func:`claimed`), on whether it becomes a
guest (:func:`settle`) and on the guest entry a guest first uses
(:func:`_guest_entry`), so that all of them replay the same recorded loop,
collectives and all. Before each solve the problem's ``data`` leaves are
copied into its entry on the stream (the problem's own ``data`` is never
written), and a loop's per-problem state (the mesh path's deflation basis
and ``'normal'`` inverse blocks) is computed again for each newly bound or
loaded problem, into the same storage.

Retention, with no knob: a live entry costs what its problem holds anyway,
plus its graph pool (the guest entry: one layout's storage more, while
guests live). Of its *released* entries a device keeps at most one,
the most recently bound one of the layout bound most recently, so that a
loop which keeps its last result while the next problem factors (``res =
GPSolver(p).solve()``) alternates between two entries and replays both. A
factorization of another layout on that device frees it (storage, pool and
graphs) before it allocates. ``RETAINED_BYTES`` counts what the released
entries keep: their storage and the segments of their graph pools. Each
entry keeps a pool of its own. A released guest entry is an entry like
the others: retained or freed by this rule, and claimed by a
factorization of its layout. :func:`clear_graph_cache` (the counterpart
of ``jax.clear_caches()``) drops every entry and the set-up verdicts. On
the CPU nothing is recorded, but entries work alike, so that the CPU tests
exercise the sharing.
"""

from __future__ import annotations

import contextlib
import dataclasses
import itertools
import weakref
from typing import Callable, Dict, List, Optional

import torch

from ..ops import graphs, linalg
from ..parallel import comm
from ..utils import tracing

_ENTRIES: Dict[tuple, List["Entry"]] = {}  # layout key -> its entries
_CLOCK = itertools.count(1)
_SHARING = True  # off inside _unshared()
# the set-up verdicts (the structure checks), keyed on residual identities,
# structure, dtype and device type, as the JAX package's _STRUCTURE_CACHE and
# _IDENTITY_ROW_CACHE
VERDICTS: Dict[tuple, object] = {}


def _storage_refs(t: torch.Tensor) -> int:
    """Tensors that hold ``t``'s storage (``t`` included)."""
    s = t.untyped_storage()
    return torch._C._storage_Use_Count(s._cdata) - 1  # less the storage object ``s``


def _check_storage_refs() -> None:
    """:meth:`Entry.free` decides from :func:`_storage_refs`, which reads a
    private PyTorch count, whether a factorization may overwrite storage
    that a user might still hold. Check at import that the count exists
    and counts what ``free`` assumes: one per tensor object on the storage,
    a detached alias and a view included, and none once they are gone."""
    if not hasattr(torch._C, "_storage_Use_Count"):
        raise ImportError(f"torch {torch.__version__} has no torch._C._storage_Use_Count, "
                          "which solvers/_reuse.py needs")
    t = torch.empty(2)
    seen = [_storage_refs(t)]
    held = (t.detach(), t[:1])
    seen.append(_storage_refs(t))
    del held
    seen.append(_storage_refs(t))
    if seen != [1, 3, 1]:
        raise ImportError(f"torch {torch.__version__} counts storage uses as {seen}, "
                          "not [1, 3, 1] as solvers/_reuse.py needs")


_check_storage_refs()


def _alias(t: torch.Tensor) -> torch.Tensor:
    """A second tensor object on ``t``'s storage that does not keep ``t``
    (the entry and the bound problem hold one each, so that a tensor kept
    past the problem shows in the storage's count)."""
    return t.detach()


class Entry:
    """The loops and storage of one problem of a layout at a time (module
    docstring).

    ``tensors[block][role]`` is the stored tensor; ``data`` the entry's own
    data leaves; ``view`` the factored problem the loops run on, made of
    the two; ``loops`` the loops by loop key; ``generation`` counts binds
    and guest loads (a loop computes its per-problem state again when it
    differs). The guest entry of a layout (``hosting``) has no bound
    problem: ``guests`` are weak references to the guests it serves and
    ``loaded`` one to the guest whose tensors it holds."""

    def __init__(self, key, problem, tensors, make_view: Callable):
        self.key = key
        self.tensors = {b: {r: _alias(t) for r, t in roles.items()} for b, roles in tensors.items()}
        self.device = next(t for roles in self.tensors.values() for t in roles.values()).device
        self.data = {k: v.clone() for k, v in problem.data.items()}
        self.view = make_view(view_problem(problem, self.data), self.tensors)
        self.loops: dict = {}
        self.pool = None
        self.owner = None  # weakref to the bound problem
        self.reserved = False  # claimed by a factorization in progress
        self.generation = 0
        self.stamp = 0
        self.hosting = False
        self.guests: List[weakref.ref] = []
        self.loaded = None
        self.nbytes = sum(t.numel() * t.element_size() for roles in self.tensors.values()
                          for t in roles.values())
        self.nbytes += sum(t.numel() * t.element_size() for t in self.data.values())

    def graph_pool(self):
        """The memory pool the entry's loops share (made at first use)."""
        if self.pool is None and self.device.type == "cuda":
            self.pool = torch.cuda.graph_pool_handle()
        return self.pool

    @property
    def released(self) -> bool:
        return (not self.reserved and (self.owner is None or self.owner() is None)
                and not any(g() is not None for g in self.guests))

    def free(self) -> bool:
        """Released, and no tensor outside the entry holds its storage."""
        if not self.released:
            return False
        held = {}  # storage -> (a tensor on it, the entry's tensors on it)
        for roles in self.tensors.values():
            for t in roles.values():
                ptr = t.untyped_storage().data_ptr()
                held[ptr] = (t, held.get(ptr, (t, 0))[1] + 1)
        return all(_storage_refs(t) <= n for t, n in held.values())

    def outputs(self) -> Dict[str, Dict[str, torch.Tensor]]:
        """New tensor objects on the storage, for a factorization to write
        into and its problem to keep."""
        return {b: {r: _alias(t) for r, t in roles.items()} for b, roles in self.tensors.items()}

    def bind(self, fp) -> None:
        self.owner = weakref.ref(fp, self._owner_gone)
        self.reserved = False
        self.hosting, self.guests, self.loaded = False, [], None
        self.generation += 1
        self.stamp = next(_CLOCK)
        object.__setattr__(fp, "entry", self)
        _settle()

    def _owner_gone(self, ref) -> None:
        if self.owner is ref:
            self.owner = None
            if _settle is not None:  # None while the interpreter shuts down
                _settle()

    def _guest_gone(self, ref) -> None:
        if ref in self.guests:
            self.guests.remove(ref)
            if not self.guests and _settle is not None:
                _settle()

    def load(self, fp) -> None:
        """Copy the problem's data leaves into the entry and, for a guest
        the entry does not hold yet, its stored tensors (on the stream: no
        host read)."""
        if self.hosting and (self.loaded is None or self.loaded() is not fp):
            for b, roles in fp.entry.tensors.items():
                for r, t in roles.items():
                    self.tensors[b][r].copy_(t, non_blocking=True)
            self.loaded = weakref.ref(fp)
            self.generation += 1
            self.stamp = next(_CLOCK)
            graphs.GUEST_LOADS += 1
        for k, v in self.data.items():
            v.copy_(fp.problem.data[k], non_blocking=True)

    def close(self) -> None:
        """Free the loops and pool, and unless a problem is bound, the
        storage."""
        self.loops.clear()
        self.pool = None
        if self.released:
            self.view = self.tensors = self.data = None


def layout_key(problem, shapes: Dict[str, tuple], extra=()) -> Optional[tuple]:
    """The layout key of ``problem`` whose blocks store tensors of
    ``shapes[block] = ((role, shape), ...)`` (module docstring), or
    ``None`` where it cannot be formed: data that is not a dict of
    tensors, or an unhashable residual (validated and solved without
    sharing, as the JAX package validates such a residual without
    caching); and inside :func:`_unshared`."""
    data = problem.data
    if not _SHARING or not isinstance(data, dict) or not all(torch.is_tensor(v)
                                                             for v in data.values()):
        return None
    key = (
        problem.device,  # first: claimed() reads it
        tuple((b.name, b.residual, shapes[b.name]) for b in problem.blocks),
        tuple((m.residual, float(m.weight)) for m in problem.misfits),
        tuple(sorted((k, tuple(v.shape), v.dtype) for k, v in data.items())),
        int(problem.latent_dim), problem.dtype, extra,
    )
    try:
        hash(key)
    except TypeError:
        return None
    return key


def view_problem(problem, data):
    """``problem`` with the entry's ``data`` and empty point sets of the
    same device and dtype (the loops read residuals and data only; points
    act through the factors)."""
    points = {k: v.new_empty((0, *v.shape[1:])) for k, v in problem.points.items()}
    return dataclasses.replace(problem, points=points, data=data, latent_init=None, trace=None)


@contextlib.contextmanager
def _unshared():
    """Factorizations in the block form no layout key, so that their
    problems share nothing with any entry: their own factors, data and
    loops (``UNSHARED``). The independent reference a shared solve is held
    to, as a solve under ``jax.disable_jit()`` is in the JAX package; a
    test hook, not an option."""
    global _SHARING
    prev, _SHARING = _SHARING, False
    try:
        yield
    finally:
        _SHARING = prev


def entries() -> List[Entry]:
    """Every entry, of every layout."""
    return [e for group in _ENTRIES.values() for e in group]


def _in_entry(t: torch.Tensor) -> bool:
    """Whether ``t``'s storage is some entry's storage."""
    ptr = t.untyped_storage().data_ptr()
    return any(s.untyped_storage().data_ptr() == ptr for e in entries() if e.tensors
               for roles in e.tensors.values() for s in roles.values())


@contextlib.contextmanager
def claimed(key, mesh=None):
    """A free entry of layout ``key`` (the one bound most recently),
    reserved for the factorization in the block, or ``None`` if there is
    none; first every released entry of another layout on the device is
    freed. An entry not bound by the end of the block is released again.

    On a ``mesh`` of ranks each rank finds its own, and the ranks agree
    (one host collective): they take it only if every rank found the entry
    of the same bind (its ``stamp``), else every rank makes a new entry.
    A rank that rebinds while another makes a new entry would record other
    graphs than it, and their collectives would never meet."""
    entry = None
    if key is not None:
        with tracing.span("factorize.bind"):
            _prune(key[0], keep=key)
            free = [e for e in _ENTRIES.get(key, ()) if e.free()]
            if free:
                entry = max(free, key=lambda e: e.stamp)
            if mesh is not None and not comm.agree(mesh, 0 if entry is None else entry.stamp,
                                                   "same"):
                entry = None
            if entry is not None:
                entry.reserved = True
    try:
        yield entry
    finally:
        if entry is not None and entry.reserved:
            entry.reserved = False
            _settle()


@dataclasses.dataclass(eq=False)
class Guest:
    """``fp.entry`` of a guest (module docstring): its layout ``key``, its
    stored ``tensors`` (as in :class:`Entry`), what a guest entry is made
    with (``make_view`` as in :func:`settle`; ``storage(roles, dtype,
    device)``, new storage of one block's roles, the factorization's own
    constructor), the ``mesh`` its ranks agree over, and the guest entry
    that serves it from its first solve on."""

    key: tuple
    tensors: Dict[str, Dict[str, torch.Tensor]]
    make_view: Callable
    storage: Callable
    mesh: object = None
    entry: Optional[Entry] = None


def _live(key) -> int:
    """Entries of layout ``key`` bound to a live problem."""
    return sum(1 for e in _ENTRIES.get(key, ()) if e.owner is not None and e.owner() is not None)


def settle(fp, key, entry, tensors, make_view: Callable, storage: Callable, mesh=None) -> None:
    """After a factorization of layout ``key``: bind ``fp`` to ``entry``,
    into whose storage it wrote; else, while fewer than two entries of the
    layout are bound to live problems, make ``fp``'s ``tensors`` (as in
    :class:`Entry`; ``make_view(problem, tensors)`` makes the factored
    problem its loops run on) a new entry of the layout; else ``fp``
    becomes a guest (``storage(roles, dtype, device)`` makes one block's
    storage for the guest entry). On a ``mesh`` of ranks the ranks agree
    on the guest (one host collective): a guest on every rank or on none.
    Without a key ``fp`` keeps loops of its own."""
    if key is None:
        graphs.UNSHARED += 1
        return
    if entry is not None:
        graphs.REBINDS += 1
        entry.bind(fp)
        return
    guest = _live(key) >= 2
    if mesh is not None:
        guest = comm.agree(mesh, guest, "all")
    if guest:
        graphs.GUESTS += 1
        object.__setattr__(fp, "entry", Guest(key, tensors, make_view, storage, mesh))
        return
    entry = Entry(key, fp.problem, tensors, make_view)
    _ENTRIES.setdefault(key, []).append(entry)
    graphs.ENTRIES += 1
    entry.bind(fp)


def bound_entry(fp) -> Optional[Entry]:
    entry = getattr(fp, "entry", None)
    if not isinstance(entry, Entry) or entry.owner is None or entry.owner() is not fp:
        return None
    return entry


def serving(fp) -> Optional[Entry]:
    """The entry whose loops serve ``fp``: its bound entry, or a guest's
    guest entry (``None`` before the guest's first solve)."""
    entry = getattr(fp, "entry", None)
    return entry.entry if isinstance(entry, Guest) else bound_entry(fp)


def _guest_entry(fp) -> Entry:
    """The guest entry that serves the guest ``fp``: the one it was served
    by, else its layout's, else a new one (storage made as a
    factorization's, after every released entry of another layout on the
    device is freed). On a mesh of ranks the ranks agree on the layout's
    guest entry (its ``stamp``, one host collective): each rank whose own
    differs from the others' drops it, and all make a new one."""
    g: Guest = fp.entry
    if g.entry is not None:
        return g.entry
    entry = next((e for e in _ENTRIES.get(g.key, ()) if e.hosting), None)
    if g.mesh is not None and comm.agree(g.mesh, 0 if entry is None else entry.stamp,
                                         "same") is None:
        if entry is not None:
            _drop(entry)  # its live guests keep it, as a bound problem keeps its entry
        entry = None
    if entry is None:
        _prune(g.key[0], keep=g.key)
        device, dtype = g.key[0], g.key[5]  # layout_key's order
        tensors = {name: g.storage(roles, dtype, device) for name, _, roles in g.key[1]}
        entry = Entry(g.key, fp.problem, tensors, g.make_view)
        entry.hosting = True
        entry.stamp = next(_CLOCK)
        _ENTRIES.setdefault(g.key, []).append(entry)
    entry.guests.append(weakref.ref(fp, entry._guest_gone))
    g.entry = entry
    _settle()
    return entry


def loops_of(fp):
    """``(loops, run_fp)``: the loops that serve ``fp`` (:func:`serving`'s
    entry's, else its own ``graphs``) and the factored problem they run on
    (the entry's view, which holds a guest's tensors from its solve on
    until another guest's, or ``fp``)."""
    entry = serving(fp)
    return (fp.graphs, fp) if entry is None else (entry.loops, entry.view)


def loop_for(fp, key, make: Callable):
    """``(loop, run_fp)``: the loop ``key`` that serves ``fp``, made by
    ``make(run_fp, pool)`` the first time, with its per-problem state
    computed for ``fp`` (``loop.prepare(loop, run_fp)``) when ``fp`` is
    newly bound or loaded into the guest entry."""
    entry = _guest_entry(fp) if isinstance(getattr(fp, "entry", None), Guest) else (
        bound_entry(fp))
    if entry is None:
        loops, run_fp, pool, generation = fp.graphs, fp, None, 0
    else:
        entry.load(fp)
        loops, run_fp, pool, generation = (entry.loops, entry.view, entry.graph_pool(),
                                           entry.generation)
    loop = loops.get(key)
    if loop is None:
        loop = loops[key] = make(run_fp, pool)
    if loop.prepare is not None and loop.bound != generation:
        loop.prepare(loop, run_fp)
        loop.bound = generation
    return loop, run_fp


def _drop(entry: Entry) -> None:
    group = _ENTRIES.get(entry.key, [])
    if entry in group:
        group.remove(entry)
        if not group:
            del _ENTRIES[entry.key]
    entry.close()


def _prune(device, keep) -> None:
    """Free the released entries on ``device`` of every layout but
    ``keep`` (a factorization of that layout is starting)."""
    if graphs.capturing:  # no graph is freed during a capture: at the next event
        return
    for e in entries():
        if e.device == torch.device(device) and e.key != keep and e.released:
            _drop(e)
    _count_retained()


def _settle() -> None:
    """After a bind or release: of its released entries each device keeps
    the most recently bound one of its most recently bound layout only."""
    if graphs.capturing:  # at the next event
        return
    every = entries()
    for device in {e.device for e in every}:
        on_device = [e for e in every if e.device == device]
        latest = max(on_device, key=lambda e: e.stamp).key
        kept = max((e for e in on_device if e.key == latest and e.released),
                   key=lambda e: e.stamp, default=None)
        for e in on_device:
            if e.released and e is not kept:
                _drop(e)
    _count_retained()


def _pool_bytes(pools) -> Dict[tuple, int]:
    """The bytes the caching allocator holds in each graph memory pool of
    ``pools`` (its segments, from the allocator's snapshot)."""
    out = {tuple(p): 0 for p in pools}
    if out:
        for seg in torch.cuda.memory_snapshot():
            pid = tuple(seg["segment_pool_id"])
            if pid in out:
                out[pid] += int(seg["total_size"])
    return out


def _count_retained() -> None:
    """``RETAINED_BYTES``: the storage and the graph pools of the released
    entries."""
    if graphs.capturing:  # the allocator is not read during a capture: at the next event
        return
    kept = [e for e in entries() if e.released]
    pools = _pool_bytes([e.pool for e in kept if e.pool is not None])
    graphs.RETAINED_BYTES = sum(e.nbytes + (0 if e.pool is None else pools[tuple(e.pool)])
                                for e in kept)


def clear_graph_cache() -> None:
    """Drop every entry (its recorded loops, pool and, once no problem holds
    it, its storage), the structure verdicts, the cached probes and the
    recorded data evaluations: the counterpart of ``jax.clear_caches()``.
    A live problem keeps its factors, and its next solve records its loop
    again."""
    for entry in entries():
        _drop(entry)
    graphs.clear_evaluations()
    VERDICTS.clear()
    linalg._PROBES.clear()
    _count_retained()
