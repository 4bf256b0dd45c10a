"""A sweep that keeps every result, on the CPU (f64).

The JAX package compiles its Gauss-Newton loop once per structure and takes
the factors as arguments (``solvers/gn.py::_gn_scan``), so one executable
serves any number of live problems. The port's recorded loop reads fixed
storage (``nonlinpdes_gpsolver_tpu_torch/solvers/_reuse.py``): a layout
keeps an entry for each of two live problems, and every problem past them
is a *guest*, its factors copied into the layout's one guest entry before
its solve. On the CPU nothing is recorded, but the guests run as on the
card: each z is held here to its JAX twin and, bitwise, to a solve that
shares nothing with any entry (``_reuse._unshared``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nonlinpdes_gpsolver_tpu as gpt
import nonlinpdes_gpsolver_tpu_torch as tpt
from nonlinpdes_gpsolver_tpu.solvers import gn as jgn
from nonlinpdes_gpsolver_tpu_torch.ops import graphs
from nonlinpdes_gpsolver_tpu_torch.solvers import _reuse
from nonlinpdes_gpsolver_tpu_torch.solvers import gn as tgn
from test_torch_structure_reuse import (
    HELD,
    MESH,
    _bound,
    _bound_as,
    _darcy,
    _elliptic,
    _elliptic_arrays,
    _scale,
    _stored,
    _storages,
    _unshared_solver,
)
from torch_threads import one_torch_thread  # noqa: F401  (autouse fixture)
from torch_time_limit import time_limit  # noqa: F401  (autouse fixture)


def _in_entry(fp):
    return any(_reuse._in_entry(t) for roles in _stored(fp).values() for t in roles.values())


def _same(res, ref):
    return torch.equal(res.z, ref.z) and torch.equal(res.state.losses, ref.state.losses)


def _sweep(kind, seeds, jax_twin=False):
    """One solver and result per seed of ``HELD[kind]``'s configuration,
    every one kept: ``(problems, solvers, results, binds)``, ``binds`` each
    run's :func:`_bound_as` and its guest loads."""
    make, kw, jax_kw = HELD[kind]
    problems, solvers, results, binds = [], [], [], []
    for s in seeds:
        pj, pt, z0 = make(s)
        graphs.reset_counts()
        solver = tpt.GPSolver(pt, **kw)
        res = solver.solve(max_iter=3, z0=torch.as_tensor(z0))
        binds.append((_bound_as(), graphs.GUEST_LOADS))
        if jax_twin:
            zj = np.asarray(gpt.GPSolver(pj, **jax_kw).solve(max_iter=3, z0=jnp.asarray(z0)).z)
            np.testing.assert_allclose(res.z.numpy(), zj, rtol=0, atol=1e-7 * _scale(zj))
        problems.append((pt, z0))
        solvers.append(solver)
        results.append(res)
    return problems, solvers, results, binds


@pytest.mark.parametrize("kind", list(HELD))
def test_sweep_keeps_every_result(kind):
    """Six problems of one structure, every solver and result kept to the
    end (the dense elliptic and Darcy problems, and the fused mesh path at
    P = 1): the first two make entries and the other four are guests of
    one guest entry, three entries in all. Each z is held to its JAX twin
    within 1e-7 of its scale and bitwise (z and losses) to an unshared
    solve; the JAX package compiles its dense loop once for the six. No
    guest's factor storage is an entry's, and each guest's first solve
    copies it into the guest entry once."""
    tpt.clear_graph_cache()
    # the held test's configuration and draws (test_torch_structure_reuse.py), kept here
    # instead of dropped: JAX's executable of them is dropped before and after, so that
    # either test sees its own compile whichever ran first in this process
    jgn._gn_scan.clear_cache()
    try:
        _sweep_keeps_every_result(kind)
    finally:
        jgn._gn_scan.clear_cache()


def _sweep_keeps_every_result(kind):
    before = jgn._gn_scan._cache_size()
    problems, solvers, results, binds = _sweep(kind, range(30, 36), jax_twin=True)
    assert binds == [(["made"], 0)] * 2 + [(["guest"], 1)] * 4
    assert len(_reuse.entries()) == 3
    host = _reuse.serving(solvers[2].fp)
    assert host is not None and host.hosting and host in _reuse.entries()
    for s in solvers[2:]:
        assert _bound(s.fp) is None and _reuse.serving(s.fp) is host
        assert not _in_entry(s.fp)
    assert len(set().union(*(_storages(s.fp) for s in solvers))) == sum(
        len(_storages(s.fp)) for s in solvers)  # six problems, no storage shared
    for (pt, z0), res in zip(problems, results):
        kw = HELD[kind][1]
        ref = _unshared_solver(pt, **kw).solve(max_iter=3, z0=torch.as_tensor(z0))
        assert _same(res, ref)
    if kind != "mesh":  # the JAX mesh path jits its loop per call
        assert jgn._gn_scan._cache_size() == before + 1


@pytest.mark.parametrize("kind", ["elliptic", "mesh"])
def test_guests_solved_out_of_order(kind):
    """After a sweep of six kept results, the guests solved again out of
    order (guest 4, guest 3, guest 4, guest 4): each change of guest copies
    its factors into the guest entry once, a repeat copies nothing, and
    every solve is bitwise its unshared solve."""
    tpt.clear_graph_cache()
    problems, solvers, results, _ = _sweep(kind, range(80, 86))
    kw = HELD[kind][1]
    refs = {i: _unshared_solver(problems[i][0], **kw).solve(
        max_iter=3, z0=torch.as_tensor(problems[i][1])) for i in (2, 3)}
    loads = []
    for i in (3, 2, 3, 3):
        graphs.reset_counts()
        res = solvers[i].solve(max_iter=3, z0=torch.as_tensor(problems[i][1]))
        loads.append(graphs.GUEST_LOADS)
        assert _same(res, refs[i]) and _same(res, results[i])
    assert loads == [1, 1, 1, 0]
    assert (graphs.ENTRIES, graphs.REBINDS, graphs.GUESTS) == (0, 0, 0)


def test_held_loop_makes_no_guest():
    """The held loop (``res = GPSolver(p).solve()``, each result kept until
    the next solve returns) never holds three live problems: no guest, no
    guest entry, no copy."""
    tpt.clear_graph_cache()
    graphs.reset_counts()
    make, kw, _ = HELD["elliptic"]
    res = None
    for k in range(5):
        pt, z0 = make(90 + k)[1:]
        res = tpt.GPSolver(pt, **kw).solve(max_iter=2, z0=torch.as_tensor(z0))
    assert (graphs.ENTRIES, graphs.REBINDS, graphs.GUESTS, graphs.GUEST_LOADS) == (2, 3, 0, 0)
    assert not any(e.hosting for e in _reuse.entries())
    del res


def test_sweep_released_keeps_one_entry():
    """Once every result of a sweep is gone, the device keeps one released
    entry of the three (the last used: the guest entry) and
    ``RETAINED_BYTES`` is what it keeps; the next problem of the layout
    binds it and is no guest."""
    tpt.clear_graph_cache()
    problems, solvers, results, _ = _sweep("elliptic", range(100, 105))
    assert len(_reuse.entries()) == 3 and graphs.RETAINED_BYTES == 0
    host = _reuse.serving(solvers[-1].fp)
    del solvers, results
    assert _reuse.entries() == [host] and host.released
    n, data = 2 * 60 + 20, sum(v.numel() for v in problems[0][0].data.values())
    assert graphs.RETAINED_BYTES == host.nbytes == 8 * (2 * n * n + n + data)
    graphs.reset_counts()
    fp = tpt.factorize(HELD["elliptic"][0](105)[1], 1e-8, solve_mode="inverse")
    assert _bound_as() == ["rebound"] and _bound(fp) is host and not host.hosting


def test_guest_storage_is_a_factorizations():
    """The guest entry's storage comes from the factorization's own
    constructor: the factor and the whitening operator one buffer,
    column-major, with the strides of a guest's own factors."""
    tpt.clear_graph_cache()
    _, solvers, _, _ = _sweep("elliptic", range(110, 113))
    host = _reuse.serving(solvers[2].fp)
    mine, its = tgn.dense_tensors(solvers[2].fp)["u"], host.tensors["u"]
    for role in ("L", "inv", "d"):
        assert its[role].stride() == mine[role].stride()
        assert its[role].storage_offset() == mine[role].storage_offset()
    assert its["L"].untyped_storage().data_ptr() == its["inv"].untyped_storage().data_ptr()


def test_checkpoint_loaded_as_third_live_problem_is_a_guest(tmp_path):
    """A problem loaded from a checkpoint while two problems of its layout
    are live is a guest, and its solve is the saved factor's."""
    tpt.clear_graph_cache()
    pt = _elliptic(_elliptic_arrays(50, 16, 120))[1]
    fp = tpt.factorize(pt, 1e-8, solve_mode="inverse")
    z = tgn.gn_solve(fp, max_iter=2).z
    tpt.utils.save_solver_state(tmp_path / "fp.npz", fp)
    live = [fp, tpt.factorize(_elliptic(_elliptic_arrays(50, 16, 121))[1], 1e-8,
                              solve_mode="inverse")]
    graphs.reset_counts()
    loaded, _ = tpt.utils.load_solver_state(tmp_path / "fp.npz", pt)
    assert _bound_as() == ["guest"] and _bound(loaded) is None and not _in_entry(loaded)
    assert torch.equal(tgn.gn_solve(loaded, max_iter=2).z, z) and graphs.GUEST_LOADS == 1
    del live


def test_mesh_guest_recomputes_its_deflation_basis():
    """Guests of the Darcy mesh ``'woodbury'`` loop at P = 1: the guest
    entry computes its deflation basis again for each guest it loads, so
    alternating two guests gives each one's unshared solve, bitwise. One
    step a solve: the basis is made when a guest is loaded, before its
    first step, which a stale one would already change."""
    tpt.clear_graph_cache()
    kw = dict(nugget=1e-3, mesh=MESH, mesh_block=16)
    pts = [_darcy(24, 10, s)[1] for s in range(130, 134)]
    solvers = [tpt.GPSolver(p, **kw) for p in pts]
    assert _bound(solvers[2].fp) is None and _bound(solvers[3].fp) is None
    zs = [solvers[i].solve(max_iter=1, step_solver="woodbury").z for i in (2, 3, 2)]
    assert solvers[2].solve(max_iter=1, step_solver="woodbury").state.deflation_rank > 0
    for i, z in zip((2, 3, 2), zs):
        ref = _unshared_solver(pts[i], **kw).solve(max_iter=1, step_solver="woodbury").z
        assert torch.equal(z, ref)
