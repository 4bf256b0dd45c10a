"""The port's spans (``utils/tracing.py``) on the CPU: the keys and
nesting of ``SolveResult.timers``, the ``build`` span of the model
constructors, records kept apart between live solvers, and the profiler
ranges of recording mode, which are absent with it off."""

import time

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import nonlinpdes_gpsolver_tpu_torch as tpt
from nonlinpdes_gpsolver_tpu_torch.utils import tracing
from torch_threads import one_torch_thread  # noqa: F401  (autouse fixture)
from torch_time_limit import time_limit  # noqa: F401  (autouse fixture)

KEYS = {"build", "build.record", "build.replay", "factorize", "factorize.assemble",
        "factorize.cholesky", "factorize.inverse", "factorize.quality", "factorize.bind",
        "gauss_newton", "gauss_newton.record", "gauss_newton.replay",
        "gauss_newton.normal_state", "gauss_newton.normal_step", "posterior_weights",
        "host_wait", "solver_host"}
CHILDREN = {"build": ("build.record", "build.replay"),
            "factorize": ("factorize.assemble", "factorize.cholesky", "factorize.inverse",
                          "factorize.quality", "factorize.bind"),
            "gauss_newton": ("gauss_newton.record", "gauss_newton.replay",
                             "gauss_newton.normal_state", "gauss_newton.normal_step")}


def _elliptic(seed=0, n_dom=40, n_bdy=16):
    gen = torch.Generator().manual_seed(seed)
    Xd, Xb = tpt.utils.sample_random(gen, n_dom, n_bdy, dtype=torch.float64)
    return tpt.models.nonlinear_elliptic(
        tpt.SquaredExponential.gaussian(0.3), Xd, Xb,
        lambda x: torch.sin(torch.pi * x[0]) * torch.sin(torch.pi * x[1]), None)


def _darcy(n_dom=40, n_bdy=12):
    gen = torch.Generator().manual_seed(3)
    Xd, Xb = tpt.utils.sample_random(gen, n_dom, n_bdy, dtype=torch.float64)
    k = tpt.SquaredExponential.gaussian(0.4)
    obs = torch.linspace(0.0, 0.01, 12, dtype=torch.float64)
    return tpt.models.darcy_flow(k, k, Xd, Xb, obs, lambda x: torch.ones_like(x[0]),
                                 noise_level=1e-2, seed=3)


@pytest.mark.parametrize("kw", [
    {"solve_mode": "inverse", "defer_quality": True},
    {"solve_mode": "trsm"},
    {"mesh": tpt.parallel.make_mesh(1, device="cpu"), "mesh_block": 16},
], ids=["inverse-deferred", "trsm", "mesh"])
def test_timers_hold_the_documented_keys_nested(kw):
    res = tpt.GPSolver(_elliptic(), nugget=1e-8, **kw).solve(max_iter=3)
    t = res.timers
    assert set(t) == KEYS == set(tracing.KEYS)
    assert all(v >= 0.0 for v in t.values()), t
    for parent, children in CHILDREN.items():
        assert sum(t[c] for c in children) <= t[parent], (parent, t)
    assert t["build"] > 0.0 and t["factorize.cholesky"] > 0.0 and t["factorize.bind"] > 0.0
    # on the CPU the phases are host seconds, inside the solver's own
    assert t["factorize"] + t["gauss_newton"] + t["posterior_weights"] <= (
        t["solver_host"] + t["host_wait"])
    rec = res.trace
    for i, (name, start, end, parent, _, _) in enumerate(rec.spans):
        assert end is not None and end >= start
        kids = [s for s in rec.spans if s[3] == i]
        assert sum(s[2] - s[1] for s in kids) <= end - start + 1e-9, name
        assert all(start <= s[1] and s[2] <= end for s in kids), name
        if "." in name:
            assert rec.spans[parent][0] in ("build", "factorize", "gauss_newton"), name
    assert all(v <= rec.seconds[n] + 1e-12 for n, v in rec.self_seconds.items())


def test_a_deferred_solve_waits_once_at_its_read():
    """The deferred verdicts and the results come back in one read, which
    the record counts as the host's wait."""
    res = tpt.GPSolver(_elliptic(), nugget=1e-8, defer_quality=True).solve(max_iter=2)
    assert res.trace.seconds["host_wait"] > 0.0
    assert res.trace.waits_in["solver"] == pytest.approx(res.timers["host_wait"])
    assert res.timers["solver_host"] == pytest.approx(
        res.trace.seconds["solver"] - res.timers["host_wait"])


@pytest.mark.parametrize("make", [_elliptic, _darcy], ids=["elliptic", "darcy"])
def test_the_constructors_time_their_build(make):
    prob = make()
    assert isinstance(prob.trace, tracing.Record)
    assert prob.trace.seconds["build"] > 0.0
    assert [s[0] for s in prob.trace.spans] == ["build"]
    res = tpt.GPSolver(prob, nugget=1e-6, solve_mode="trsm").solve(max_iter=1)
    assert res.timers["build"] == prob.trace.seconds["build"]
    # the problem's record is the solver's start, not shared with it
    assert [s[0] for s in prob.trace.spans] == ["build"]


def test_the_trace_is_no_part_of_a_problems_identity():
    prob = _elliptic()
    other = tpt.models.spec.CollocationProblem(**{
        f: getattr(prob, f) for f in ("name", "blocks", "points", "data", "latent_dim",
                                      "misfits", "latent_init")})
    assert other.trace is None and prob == other
    assert "trace" not in repr(prob)


def test_interleaved_solvers_keep_their_spans_apart():
    calls = {"a": [], "b": []}
    solvers = {}
    for name, seed in (("a", 1), ("b", 2)):
        t0 = time.perf_counter()
        solvers[name] = tpt.GPSolver(_elliptic(seed), nugget=1e-8, solve_mode="trsm")
        calls[name].append((t0, time.perf_counter()))
    for name in ("a", "b", "a", "b", "b"):
        t0 = time.perf_counter()
        solvers[name].solve(max_iter=1)
        calls[name].append((t0, time.perf_counter()))
    for name, sv in solvers.items():
        spans = [s for s in sv.trace.spans if s[0] != "build"]
        assert sum(s[0] == "gauss_newton" for s in spans) == len(calls[name]) - 1
        assert sum(s[0] == "factorize" for s in spans) == 1
        for _, start, end, *_ in spans:
            assert any(c0 <= start and end <= c1 for c0, c1 in calls[name]), name
    assert tracing.current() is None


def test_spans_outside_a_solve_add_to_nothing():
    with tracing.span("factorize.assemble"):
        pass
    tracing.waited(time.perf_counter())
    assert tracing.current() is None
    rec = tracing.Record()
    with rec.solving():
        assert tracing.current() is rec
        with tracing.span("factorize"), tracing.span("factorize.assemble"):
            tracing.waited(time.perf_counter() - 0.5)
    assert tracing.current() is None
    assert rec.seconds["host_wait"] >= 0.5 and rec.waits_in["factorize"] >= 0.5
    assert rec.self_seconds["factorize.assemble"] < rec.seconds["factorize.assemble"] - 0.49
    assert [s[3] for s in rec.spans] == [-1, 0, 1]


def _gp_events(prof):
    return [e for e in prof.events() if e.name.startswith("gp.")]


def _within(inner, outer):
    return (outer.time_range.start <= inner.time_range.start
            and inner.time_range.end <= outer.time_range.end)


def test_recording_puts_the_spans_in_the_profile_nested():
    prob = _elliptic()
    tpt.GPSolver(prob, nugget=1e-8, solve_mode="trsm").solve(max_iter=1)  # warm
    with tracing.recording(), profile(activities=[ProfilerActivity.CPU]) as prof:
        res = tpt.GPSolver(prob, nugget=1e-8, solve_mode="trsm").solve(max_iter=1)
        res.posterior.extend(tpt.utils.test_grid(5, 5, device="cpu"))
    events = _gp_events(prof)
    names = {e.name for e in events}
    assert {"gp.solver", "gp.factorize", "gp.factorize.assemble", "gp.factorize.cholesky",
            "gp.factorize.bind", "gp.gauss_newton", "gp.posterior_weights",
            "gp.extend"} <= names, names
    by_name = {}
    for e in events:
        by_name.setdefault(e.name, []).append(e)
    for e in events:
        parent = {"gp.factorize": "gp.solver", "gp.gauss_newton": "gp.solver",
                  "gp.posterior_weights": "gp.solver"}.get(e.name)
        if e.name.startswith(("gp.factorize.", "gp.gauss_newton.")):
            parent = e.name.rsplit(".", 1)[0]
        if parent is not None:
            assert any(_within(e, p) for p in by_name[parent]), e.name
    chol = [e for e in prof.events() if e.name == "aten::linalg_cholesky_ex"]
    fact = by_name["gp.factorize"]
    assert any(_within(c, f) for c in chol for f in fact)
    assert not tracing._recording


def test_with_recording_off_a_profiled_solve_holds_no_span():
    prob = _elliptic()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        res = tpt.GPSolver(prob, nugget=1e-8, solve_mode="trsm").solve(max_iter=1)
        res.posterior.extend(tpt.utils.test_grid(5, 5, device="cpu"))
    assert not _gp_events(prof)
    assert any(e.name == "aten::linalg_cholesky_ex" for e in prof.events())
