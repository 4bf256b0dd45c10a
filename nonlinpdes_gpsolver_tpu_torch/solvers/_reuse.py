"""Gauss-Newton loops shared by every problem of one structure.

The JAX package compiles its Gauss-Newton loop once per problem
*structure* (``solvers/gn.py::_gn_scan`` there takes the factors and data
as arguments and is keyed on the residual functions, the misfit weights
and the static options), so a problem rebuilt on fresh points and data
reuses the executable. The port's counterpart of that executable is a loop
recorded as CUDA graphs (``gn.py::_Loop``), and a recorded graph reads
fixed storage. So the storage is shared too: an :class:`Entry`, one per
*layout*, owns

* the storage its graphs read: each block's factor, whitening operator and
  column scales (the mesh path: the rank's factor rows, the diagonal-block
  inverses and the column scales), and its own copy of each ``data`` leaf;
* its loops, one per *loop key* (the routed step solver and the static
  options), sharing one graph memory pool;
* a weak reference to the factored problem *bound* to it, whose factors
  are that storage.

The **layout key** (:func:`layout_key`) is what fixes that storage: per
block its name, its residual function and the shapes of its stored
tensors (which also say whether it whitens through an explicit inverse);
per misfit its function and weight (``sqrt(weight)`` is recorded into the
graph); each data leaf's name, shape and dtype; the latent size, the dtype
and the device; on the mesh path the mesh (its size and this rank), the
row block and the padded size. Points and kernels are in neither key: they
act only through the factors. Model constructors build their residuals
with ``lru_cache``'d factories, so one configuration gives one key.

Binding. A factorization first claims (:func:`claimed`) the entry of its layout; an
entry is free once its bound problem is gone and nothing outside the entry
still holds its storage. The factorization then writes its outputs
straight into that storage (no second copy of a factor is ever resident)
and the new problem binds (``REBINDS``). Without an entry the problem's own
tensors become a new entry (``ENTRIES``). An entry that is not free (its
bound problem is alive) is never shared: the second live problem of that
layout keeps loops of its own in ``fp.graphs`` (``UNSHARED``), so two live
solvers never read each other's factors. Before each solve the bound
problem's ``data`` leaves are copied into the entry on the stream (the
problem's own ``data`` is never written), and a loop's per-problem state
(the mesh path's deflation basis and ``'normal'`` inverse blocks) is
computed again for each newly bound problem, into the same storage.

Retention, with no knob: an entry lives while its bound problem does.
After that each device keeps only its most recently bound entry, and a
factorization of another layout on that device frees it (storage, pool and
graphs) before it allocates. ``RETAINED_BYTES`` counts what the released
entries keep: their storage and the segments of their graph pools. :func:`clear_graph_cache` (the counterpart of
``jax.clear_caches()``) drops every entry and the set-up verdicts. On the
CPU nothing is recorded, but entries work alike, so that the CPU tests
exercise the sharing.
"""

from __future__ import annotations

import contextlib
import dataclasses
import itertools
import weakref
from typing import Callable, Dict, Optional

import torch

from ..ops import graphs, linalg

_ENTRIES: Dict[tuple, "Entry"] = {}
_CLOCK = itertools.count(1)
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
    """The loops and storage of one layout (module docstring).

    ``tensors[block][role]`` is the stored tensor; ``data`` the entry's own
    data leaves; ``view`` the factored problem the loops run on, made of
    the two; ``loops`` the loops by loop key; ``generation`` counts binds
    (a loop computes its per-problem state again when it differs)."""

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
        return not self.reserved and (self.owner is None or self.owner() is None)

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
        self.generation += 1
        self.stamp = next(_CLOCK)
        object.__setattr__(fp, "entry", self)
        _settle()

    def _owner_gone(self, ref) -> None:
        if self.owner is ref:
            self.owner = None
            if _settle is not None:  # None while the interpreter shuts down
                _settle()

    def load(self, fp) -> None:
        """Copy the bound problem's data leaves into the entry (on the
        stream: no host read)."""
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
    caching)."""
    data = problem.data
    if not isinstance(data, dict) or not all(torch.is_tensor(v) for v in data.values()):
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
    return dataclasses.replace(problem, points=points, data=data, latent_init=None)


@contextlib.contextmanager
def claimed(key):
    """The free entry of layout ``key``, reserved for the factorization in
    the block (``None`` if there is none); first every other released
    entry on the device is freed. An entry not bound by the end of the
    block is released again."""
    entry = None
    if key is not None:
        _prune(key[0], keep=key)
        entry = _ENTRIES.get(key)
        if entry is not None and entry.free():
            entry.reserved = True
        else:
            entry = None
    try:
        yield entry
    finally:
        if entry is not None and entry.reserved:
            entry.reserved = False
            _settle()


def settle(fp, key, entry, tensors, make_view: Callable) -> None:
    """After a factorization of layout ``key``: bind ``fp`` to ``entry``,
    into whose storage it wrote; else make ``fp``'s ``tensors`` (as in
    :class:`Entry`; ``make_view(problem, tensors)`` makes the factored
    problem its loops run on) a new entry, unless the layout's entry is
    not free (then ``fp`` keeps loops of its own)."""
    if key is None:
        return
    if entry is not None:
        graphs.REBINDS += 1
        entry.bind(fp)
        return
    old = _ENTRIES.get(key)
    if old is not None:
        if not old.free():
            graphs.UNSHARED += 1
            return
        _drop(old)
    entry = _ENTRIES[key] = Entry(key, fp.problem, tensors, make_view)
    graphs.ENTRIES += 1
    entry.bind(fp)


def bound_entry(fp) -> Optional[Entry]:
    entry = getattr(fp, "entry", None)
    if entry is None or entry.owner is None or entry.owner() is not fp:
        return None
    return entry


def loops_of(fp):
    """``(loops, run_fp)``: the loops that serve ``fp`` (its entry's when
    it is bound, else its own ``graphs``) and the factored problem they run
    on (the entry's view, or ``fp``)."""
    entry = bound_entry(fp)
    return (fp.graphs, fp) if entry is None else (entry.loops, entry.view)


def loop_for(fp, key, make: Callable):
    """``(loop, run_fp)``: the loop ``key`` that serves ``fp``, made by
    ``make(run_fp, pool)`` the first time, with its per-problem state
    computed for ``fp`` (``loop.prepare(loop, run_fp)``) when ``fp`` is
    newly bound."""
    entry = bound_entry(fp)
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
    if _ENTRIES.get(entry.key) is entry:
        del _ENTRIES[entry.key]
    entry.close()


def _prune(device, keep=None) -> None:
    """Free the released entries on ``device``: all but ``keep``'s (a
    factorization of that layout is starting), or without ``keep`` all but
    the most recently bound entry of the device."""
    if graphs.capturing:  # no graph is freed during a capture: at the next event
        return
    on_device = [e for e in _ENTRIES.values() if e.device == torch.device(device)]
    if keep is None and on_device:
        keep = max(on_device, key=lambda e: e.stamp).key
    for e in on_device:
        if e.key != keep and e.released:
            _drop(e)
    _count_retained()


def _settle() -> None:
    """After a bind or release: each device keeps its latest entry only."""
    for device in {e.device for e in _ENTRIES.values()}:
        _prune(device)
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
    kept = [e for e in _ENTRIES.values() if e.released]
    pools = _pool_bytes([e.pool for e in kept if e.pool is not None])
    graphs.RETAINED_BYTES = sum(e.nbytes + (0 if e.pool is None else pools[tuple(e.pool)])
                                for e in kept)


def clear_graph_cache() -> None:
    """Drop every entry (its recorded loops, pool and, once no problem holds
    it, its storage), the structure verdicts and the cached probes: the
    counterpart of ``jax.clear_caches()``. A live problem keeps its
    factors, and its next solve records its loop again."""
    for entry in list(_ENTRIES.values()):
        _drop(entry)
    VERDICTS.clear()
    linalg._PROBES.clear()
    _count_retained()
