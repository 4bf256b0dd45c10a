#!/usr/bin/env python3
"""Where a benchmark cell's solve spends its host time, by the port's spans.

    python3 scripts/torch_span_split.py --workload elliptic-n900-fresh \\
        [--seeds 11 12 13] [--seconds 10] [--out chiprun_out/spans.jsonl]

For each seed it runs the cell's stream as ``gpbench/run.py`` does (its
warm-up, then ``--seconds`` of solves with tracing off) and prints one
JSON line: the mean of every key of ``SolveResult.timers`` (ms), the mean
self time of every span of the solve's record (``utils/tracing.py``), the
harness's ``extend`` time, the median latency and the share of it that
``build + solver_host + host_wait`` covers. Then, once:

* ``span_cost``: the host cost of the spans with tracing off, by replaying
  one real solve's spans, phase events and accruals with empty bodies
  (against the same walk without them), in us a solve;
* ``recording``: traced stretches of at least a second, as the harness
  traces them, alternately with ``tracing.recording()`` off and on: the
  mean latency of each, whether the profile holds a ``gp.`` event, and
  from the last one with recording on the device's idle time named by the
  innermost ``gp.`` span the host was in (else the harness span).

On the card by default; ``--device cpu --sizes '{"n_domain": 50,
"n_boundary": 16}'`` rehearses it on the CPU in float64 at a cut size.
"""

import argparse
import json
import statistics
import subprocess
import sys
import time
from collections import defaultdict
from contextlib import nullcontext
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))


def card() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else "not read"


class Traces:
    """Keeps each ``SolveResult``'s record while installed."""

    def __init__(self, tpt):
        self.tpt, self.kept, self.orig = tpt, [], tpt.GPSolver.solve

    def __enter__(self):
        orig, kept = self.orig, self.kept

        def solve(solver, *a, **k):
            res = orig(solver, *a, **k)
            kept.append(res.trace)
            return res

        self.tpt.GPSolver.solve = solve
        return self

    def __exit__(self, *exc):
        self.tpt.GPSolver.solve = self.orig


def window(stream, seconds, no_span):
    records = []
    w0 = time.perf_counter()
    while not records or time.perf_counter() - w0 < seconds:
        rec = stream.one(no_span)
        rec.pop("outputs", None)
        records.append(rec)
    return records


def split(records, traces) -> dict:
    done = [r for r in records if r["error"] is None]
    keys = sorted({k for r in done for k in r["timers"]})
    timers = {k: 1e3 * statistics.fmean(r["timers"][k] for r in done) for k in keys}
    names = sorted({n for t in traces for n in t.self_seconds})
    self_ms = {n: 1e3 * statistics.fmean(t.self_seconds.get(n, 0.0) for t in traces)
               for n in names}
    lat = statistics.median(r["latency_s"] for r in done)
    covered = timers["build"] + timers["solver_host"] + timers["host_wait"]
    return {"solves": len(done), "timers_ms": timers, "self_ms": self_ms,
            "extend_ms": 1e3 * statistics.fmean(r["extend_s"] for r in done),
            "latency_median_ms": 1e3 * lat, "covered_ms": covered,
            "covered_share": covered / (1e3 * lat),
            "spans_per_solve": statistics.fmean(len(t.spans) for t in traces)}


def span_cost(tracing, trace, accruals: int, device, reps: int = 2000) -> dict:
    """us a solve of ``trace``'s spans, phase events and ``accruals``
    accruals with empty bodies, less the same walk with no span: in all
    (``us_per_solve``), without the events (``spans_us``), and with
    events made afresh each time instead of reused (``fresh_events_us``)."""
    spans = trace.spans
    kids = defaultdict(list)
    for i, s in enumerate(spans):
        kids[s[3]].append(i)

    def walk(rec, i, mode):
        name = spans[i][0]
        if mode == "walk":
            cm = nullcontext()
        elif name == tracing.SOLVER:
            cm = rec.solving()
        elif name in tracing.PHASES:
            cm = rec.phase(name, "cpu" if mode == "spans" else device)
        else:
            cm = tracing.span(name)
        with cm:
            for c in kids[i]:
                walk(rec, c, mode)

    def one(mode):
        if mode == "fresh":
            tracing._FREE_EVENTS.clear()
        rec = tracing.Record() if mode != "walk" else None
        for i in kids[-1]:
            walk(rec, i, mode)
        with rec.solving() if rec is not None else nullcontext():
            for _ in range(accruals):
                tracing.waited(time.perf_counter())
        if rec is not None:
            rec.timers()

    out = defaultdict(list)
    for _ in range(2):
        for mode in ("walk", "spans", "full", "fresh"):
            t0 = time.perf_counter()
            for _ in range(reps):
                one(mode)
            out[mode].append(1e6 * (time.perf_counter() - t0) / reps)
    us = {m: min(v) for m, v in out.items()}
    return {"us_per_solve": us["full"] - us["walk"], "spans_us": us["spans"] - us["walk"],
            "fresh_events_us": us["fresh"] - us["spans"], "walk_us": us["walk"],
            "spans": len(spans), "accruals": accruals}


def idle_by_innermost(prof, harness_spans) -> dict:
    from gpbench import trace as tr

    device, gp, outer = [], [], []
    for name, on_device, start, end in tr._events(prof):
        if on_device:
            if not name.startswith("gp.") and name not in harness_spans:
                device.append((start, end))
        elif name.startswith("gp."):
            gp.append((start, end, name))
        elif name in harness_spans:
            outer.append((start, end, name))
    t0, t1 = min(s for s, _, _ in outer), max(e for _, e, _ in outer)
    device = sorted((max(s, t0), min(e, t1)) for s, e in device if e > t0 and s < t1)

    def named(t):
        inner = [(e - s, n) for s, e, n in gp if s <= t <= e]
        if inner:
            return min(inner)[1]
        return next(("harness:" + n for s, e, n in outer if s <= t <= e), "other")

    idle, edge = defaultdict(float), t0
    for s, e in device + [(t1, t1)]:
        if s > edge:
            idle[named((edge + s) // 2)] += (s - edge) / 1e9
        edge = max(edge, e)
    busy = sum(e - s for s, e in _union(device)) / 1e9
    return {"window_s": (t1 - t0) / 1e9, "busy_s": busy,
            "idle_s": dict(sorted(idle.items(), key=lambda kv: -kv[1]))}


def _union(iv):
    out = []
    for s, e in sorted(iv):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", default=[11, 12, 13])
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--traced", type=int, default=4, help="traced stretches, off and on in turn")
    ap.add_argument("--out", default=None)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--sizes", type=json.loads, default=None, help="sizes replacing the mix's")
    args = ap.parse_args()

    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    import nonlinpdes_gpsolver_tpu_torch as tpt
    from gpbench import harness
    from nonlinpdes_gpsolver_tpu_torch.ops import graphs
    from nonlinpdes_gpsolver_tpu_torch.utils import tracing

    device = torch.device(args.device)
    on_card = device.type == "cuda"
    if on_card and not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 2
    lines = []

    def emit(obj):
        obj = {"workload": args.workload, "card": card_name, **obj}
        lines.append(obj)
        print(json.dumps(obj), flush=True)

    card_name = card() if on_card else "cpu"
    cell = harness.Cell(ROOT, args.workload)
    if args.sizes:
        cell.mix = {**cell.mix, **args.sizes}
    dtype = getattr(torch, cell.cfg["dtype"]) if on_card else torch.float64
    ctx = cell.pde.setup(cell.cfg, device, dtype)
    stream = None
    for seed in args.seeds:
        if stream is not None:
            stream.release()
        stream = harness.Stream(tpt, cell, seed, device, dtype, ctx)
        harness.warm_up(stream, graphs)
        with Traces(tpt) as kept:
            records = window(stream, args.seconds, harness.no_span)
        emit({"seed": seed, **split(records, kept.kept)})

    # accruals a solve, counted on a few more solves
    counts = defaultdict(int)
    orig = tracing.Record.accrue

    def counting(rec, name, seconds):
        counts[name] += 1
        orig(rec, name, seconds)

    tracing.Record.accrue = counting
    try:
        with Traces(tpt) as kept:
            n = len(window(stream, 1.0, harness.no_span))
    finally:
        tracing.Record.accrue = orig
    per_solve = {k: v / n for k, v in counts.items()}
    emit({"span_cost": span_cost(tracing, kept.kept[-1], round(sum(per_solve.values())), device),
          "accruals_per_solve": per_solve})

    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if on_card else [])
    for i in range(args.traced):
        on = i % 2 == 1
        if on_card:
            torch.cuda.synchronize()
        profiled = []
        with profile(activities=activities) as prof:
            with tracing.recording() if on else nullcontext():
                p0 = time.perf_counter()
                while not profiled or time.perf_counter() - p0 < 1.0:
                    profiled.append(stream.one(record_function))
                    profiled[-1].pop("outputs", None)
        row = {"recording": on, "solves": len(profiled),
               "latency_mean_ms": 1e3 * statistics.fmean(r["latency_s"] for r in profiled),
               "gp_events": sum(1 for e in prof.events() if e.name.startswith("gp."))}
        if on and i == args.traced - 1:
            row["idle"] = idle_by_innermost(prof, harness.SPANS)
        del prof
        emit({"traced": row})
    stream.release()
    if args.out:
        with open(args.out, "a") as f:
            f.writelines(json.dumps(x) + "\n" for x in lines)
    return 0


if __name__ == "__main__":
    sys.exit(main())
