"""One run of one cell: set-up, the measured window, the traced slice, the
comparison with the plain reference, and the result line.

Everything a cell needs is found by name from ``BENCHMARK.json``: the
cell's configuration (``configs/<config>.json``, whose ``pde`` names the
problem's module ``pdes/<pde>.py`` and its plain reference
``reference/<pde>.py``), its traffic mix (``traffic/<traffic>.json``,
read by ``generator.py``) and each per-layer metric's reader
(``layer_metrics/<metric>.py``). A metric named ``<base>.<qualifier>``
measures what ``<base>`` measures, in cells that bind it apart (see
:func:`base_name`).

The caller solves one problem after another (``generator.py``): solve
``k`` draws its inputs from ``(seed, k)``, hands them to the program's
model constructor, ``GPSolver(problem, ...)``, ``solve(max_iter, z0)`` and
``posterior.extend`` on the test points, and reads the test errors on the
host. Its latency runs from the constructor to that read. Set-up warms the
cell's shapes until a solve records no CUDA graph and makes no new entry
of the recorded loop. The window then runs for ``seconds`` and ends at the
first solve that completes after them. With ``trace``, whole solves after
the window run under ``torch.profiler`` (at least one, and at least a
second). A sample of the window's solves is drawn from the seed as they
complete, and only its outputs stay on the card. Once the program's state
is freed, the plain reference solves the sample again from the same
inputs, and the largest gaps decide ``correct``.
"""

from __future__ import annotations

import gc
import importlib
import importlib.util
import json
import math
import statistics
import sys
import time
from contextlib import nullcontext
from pathlib import Path

import numpy as np
import torch

from gpbench import generator
from gpbench import trace as tr

SPANS = ("draw", "build_problem", "factorize", "solve", "extend", "errors")
FORBIDDEN = ("jax", "jaxlib", "flax", "nonlinpdes_gpsolver_tpu")
GIB = float(2**30)
MAX_WARMUP = 12


class Cell:
    """A cell of ``BENCHMARK.json`` with its configuration, mix and metrics."""

    def __init__(self, root: Path, name: str):
        self.root = Path(root)
        bench = json.loads((self.root / "BENCHMARK.json").read_text())
        cells = {w["name"]: w for w in bench["workloads"]}
        if name not in cells:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json: {sorted(cells)}")
        self.name, self.spec = name, cells[name]
        config = {c["name"]: c for c in bench["configs"]}[self.spec["config"]]
        self.cfg = json.loads((self.root / config["file"]).read_text())
        self.mix = generator.load(self.root / "gpbench" / "traffic"
                                  / f"{self.spec['traffic']}.json")
        self.chips = int(self.spec["chips"])
        self.end_to_end = [m for m in bench["end_to_end"] if self._reports(m)]
        self.per_layer = [m for m in bench["per_layer"] if self._reports(m)]

    def _reports(self, metric: dict) -> bool:
        return self.name in metric.get("workloads", [self.name])

    @property
    def pde(self):
        return importlib.import_module(f"gpbench.pdes.{self.cfg['pde']}")

    @property
    def reference(self):
        return importlib.import_module(f"gpbench.reference.{self.cfg['pde']}")


def base_name(metric: str) -> str:
    """What a metric measures: its name up to the first ``.``. A metric
    ``<base>.<qualifier>`` measures the same as ``<base>`` in other cells,
    under a bound or a moved metric of its own."""
    return metric.split(".")[0]


def reader(root: Path, metric: str):
    """The ``read(ctx)`` of ``layer_metrics/<base name of metric>.py``."""
    base = base_name(metric)
    path = Path(root) / "gpbench" / "layer_metrics" / f"{base}.py"
    spec = importlib.util.spec_from_file_location(f"gpbench_layer_metric_{base}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def forbidden_modules() -> list:
    """Top-level names in ``sys.modules`` that are JAX or the JAX package."""
    return sorted({n.split(".")[0] for n in list(sys.modules)} & set(FORBIDDEN))


class Stream:
    """The caller: solve after solve of one cell, the last result held
    until the next returns."""

    def __init__(self, tpt, cell: Cell, seed: int, device, dtype, ctx: dict):
        self.tpt, self.cell, self.seed = tpt, cell, seed
        self.device, self.dtype, self.ctx = device, dtype, ctx
        self.pde = cell.pde
        self.sizes = generator.sizes(cell.mix)
        self.held = None
        self.mesh = None
        self.k = 0
        self.sync_extend = False
        self.gen = torch.Generator(device=device)

    def _solver_kwargs(self) -> dict:
        kw = {"nugget": self.cell.cfg["nugget"], "nugget_type": self.cell.cfg["nugget_type"]}
        if self.sizes["mesh"]:
            if self.mesh is None:
                self.mesh = self.tpt.parallel.make_mesh(self.sizes["mesh"], device=self.device)
            kw["mesh"] = self.mesh
        return kw

    def draw(self, k: int) -> dict:
        self.gen.manual_seed(generator.solve_seed(self.seed, k))
        return self.pde.draw(self.cell.cfg, self.sizes, self.gen, self.dtype, self.ctx)

    def one(self, span) -> dict:
        """Solve the next problem, each call into it inside ``span(name)``;
        returns its record, with its ``outputs`` on the card."""
        k = self.k
        self.k += 1
        with span("draw"):
            inputs = self.draw(k)
        rec = {"k": k, "ok": False, "error": None}
        t0 = time.perf_counter()
        try:
            with span("build_problem"):
                problem = self.pde.build(self.tpt, self.cell.cfg, inputs, self.ctx)
            with span("factorize"):
                solver = self.tpt.GPSolver(problem, **self._solver_kwargs())
            del problem
            with span("solve"):
                result = solver.solve(max_iter=self.cell.cfg["gn_steps"], z0=inputs["z0"])
            with span("extend"):
                if self.sync_extend:
                    torch.cuda.synchronize()
                te = time.perf_counter()
                outputs = self.pde.extend(result, self.ctx)
                if self.sync_extend:
                    torch.cuda.synchronize()
                rec["extend_s"] = time.perf_counter() - te
            with span("errors"):
                vals = torch.cat([self.pde.gate_values(outputs, self.ctx).to(torch.float64),
                                  torch.isfinite(outputs["z"]).all().to(torch.float64).reshape(1)])
                vals = vals.tolist()
            rec["latency_s"] = time.perf_counter() - t0
            rec["gates"] = dict(zip(self.pde.GATES, vals[:-1]))
            rec["finite"] = vals[-1] == 1.0
            rec["ok"] = rec["finite"] and all(
                math.isfinite(v) and v <= self.cell.cfg["gates"][g]
                for g, v in rec["gates"].items())
            rec["outputs"] = {n: outputs[n].detach() for n in self.pde.OUTPUTS}
            rec["timers"] = dict(result.timers)
            rec["cg_iters"] = int(result.state.cg_iters.sum())
            rec["rungs"] = dict(result.posterior.fp.rungs)
            self.held = (solver, result)
        except Exception as exc:  # a solve that raises is counted and the stream goes on
            rec["latency_s"] = time.perf_counter() - t0
            rec["error"] = f"{type(exc).__name__}: {exc}"
            print(f"solve {k} raised {rec['error']}", file=sys.stderr, flush=True)
        rec["t_done"] = time.perf_counter()
        return rec

    def release(self):
        self.held = None
        self.mesh = None


class Sample:
    """A uniform sample of ``n`` of the records offered, drawn from
    ``seed`` as they come (reservoir sampling): only the sample's outputs
    stay on the card, so the memory a run holds does not grow with its
    solves. ``kept`` is ``[(k, outputs)]``."""

    def __init__(self, n: int, seed: int):
        self.n, self.seen, self.kept = int(n), 0, []
        self.rng = np.random.default_rng([int(seed) % 2**64, 7])

    def offer(self, rec: dict):
        outputs = rec.pop("outputs", None)
        if outputs is None:
            return
        i, self.seen = self.seen, self.seen + 1
        if i < self.n:
            self.kept.append((rec["k"], outputs))
        else:
            j = int(self.rng.integers(0, i + 1))
            if j < self.n:
                self.kept[j] = (rec["k"], outputs)


def no_span(name: str):
    """The span of an untraced call: none."""
    return nullcontext()


def warm_up(stream: Stream, graphs) -> list:
    """Set-up's solves, until a solve neither records a graph nor makes a
    new entry of the recorded loop (at least three, at most
    ``MAX_WARMUP``); their outputs are dropped."""
    warm = []
    for _ in range(MAX_WARMUP):
        cap, ent = graphs.CAPTURES, graphs.ENTRIES
        warm.append(stream.one(no_span))
        warm[-1].pop("outputs", None)
        if len(warm) >= 3 and graphs.CAPTURES == cap and graphs.ENTRIES == ent:
            break
    print(f"warm-up: {len(warm)} solves, latencies "
          f"{[round(r['latency_s'], 4) for r in warm]}", file=sys.stderr, flush=True)
    return warm


def _quantile_95(values):
    return float(np.percentile(np.asarray(values, dtype=np.float64), 95))


def compare(cell: Cell, stream: Stream, sample: list, limits: dict, working_dtype=None,
            control=None) -> dict:
    """The largest gap of each compared output over ``sample``
    (``[(k, outputs)]``) against the plain reference in float64, its
    nugget rule in ``working_dtype`` (the configuration's by default). A
    gap is ``max|prog - ref| / max|ref|``. With ``control`` (a
    ``reference.linalg.Precision``) the reference in that precision is put
    in the program's place, and ``outputs`` may be ``None``; a control
    that raises reads infinite gaps."""
    from gpbench.reference.linalg import Precision

    wd = working_dtype or getattr(torch, cell.cfg["dtype"])
    gaps = {name: 0.0 for name in limits}
    t0 = time.perf_counter()
    for k, outputs in sample:
        inputs = stream.draw(k)
        ref = cell.reference.solve(cell.cfg, inputs, stream.ctx["X_test"],
                                   Precision("float64"), wd)
        if control is not None:
            try:
                outputs = cell.reference.solve(cell.cfg, inputs, stream.ctx["X_test"], control, wd)
            except Exception as exc:  # a control that crashes has failed
                print(f"control raised {type(exc).__name__}: {exc}", file=sys.stderr)
                outputs = None
        row = {}
        for name in limits:
            out = name.removesuffix("_gap")
            r = ref[out].to(torch.float64)
            gap = math.inf
            if outputs is not None:
                p = outputs[out].to(device=r.device, dtype=torch.float64)
                gap = float(torch.max(torch.abs(p - r)) / torch.max(torch.abs(r)))
            row[name] = gap if math.isfinite(gap) else math.inf
            gaps[name] = max(gaps[name], row[name])
        print(f"compared solve {k}: {row}; reference nugget scales {ref['scales']}",
              file=sys.stderr, flush=True)
        del ref, inputs, outputs
    return {"gaps": gaps, "compared": [k for k, _ in sample],
            "seconds": time.perf_counter() - t0}


def judge(cmp: dict, limits: dict, raised: int = 0) -> tuple:
    """``(checks, correct)``: each gap of ``cmp`` beside its limit, and
    whether none of ``raised`` solves raised or went non-finite, something
    was compared and every gap is within its limit."""
    checks = {name: {"value": cmp["gaps"][name], "limit": lim} for name, lim in limits.items()}
    correct = (not raised and bool(cmp["compared"])
               and all(c["value"] <= c["limit"] for c in checks.values()))
    return checks, correct


def run(root: Path, workload: str, seed: int, seconds: float, trace: bool, t_start: float,
        device=None, sizes_override=None) -> tuple:
    """One run; returns ``(result, checks)``: the result line's object and
    the numbers compared with their limits. ``device="cpu"`` and
    ``sizes_override`` (sizes replacing the mix's) serve the CPU tests;
    ``work`` in the per-layer readers' context is the Gram work of all the
    profiled solves, by kernel."""
    import nonlinpdes_gpsolver_tpu_torch as tpt
    from nonlinpdes_gpsolver_tpu_torch.ops import graphs

    cell = Cell(root, workload)
    if sizes_override:
        cell.mix = {**cell.mix, **sizes_override}
    device = torch.device(device or "cuda")
    on_card = device.type == "cuda"
    dtype = getattr(torch, cell.cfg["dtype"]) if on_card else torch.float64
    pde = cell.pde
    ctx = pde.setup(cell.cfg, device, dtype)
    stream = Stream(tpt, cell, seed, device, dtype, ctx)

    warm = warm_up(stream, graphs)
    if on_card:
        torch.cuda.synchronize()
        setup_peak = torch.cuda.max_memory_reserved()
        torch.cuda.reset_peak_memory_stats()
    c0 = {n: getattr(graphs, n) for n in ("CAPTURES", "HOST_READS")}
    stream.sync_extend = trace and on_card
    setup_s = time.perf_counter() - t_start

    # the window
    sample = Sample(cell.cfg["compare_solves"], seed)
    records, draw_s = [], 0.0
    cpu0, thread0 = time.process_time(), time.thread_time()
    w0 = time.perf_counter()
    while True:
        d0 = time.perf_counter()
        rec = stream.one(no_span)
        draw_s += time.perf_counter() - d0 - rec["latency_s"]
        sample.offer(rec)
        records.append(rec)
        if time.perf_counter() - w0 >= seconds:
            break
    window_s = time.perf_counter() - w0
    cpu_s, thread_s = time.process_time() - cpu0, time.thread_time() - thread0
    counters = {n: getattr(graphs, n) - v for n, v in c0.items()}
    retained = graphs.RETAINED_BYTES
    if on_card:
        torch.cuda.synchronize()
        reserved_peak = torch.cuda.max_memory_reserved()
        alloc_peak = torch.cuda.max_memory_allocated()
    else:
        setup_peak = reserved_peak = alloc_peak = 0
    quarters = [[], [], [], []]
    for r in records:
        quarters[min(3, int(4 * (r["t_done"] - w0) / window_s))].append(r["latency_s"])
    print(f"window: {len(records)} solves in {window_s:.4f} s; draws {draw_s:.4f} s; "
          f"process CPU {cpu_s:.4f} s, main thread {thread_s:.4f} s; median latency by quarter "
          f"{[round(statistics.median(q), 5) if q else None for q in quarters]}",
          file=sys.stderr, flush=True)

    summary, profiled = None, []
    if trace:
        from torch.profiler import ProfilerActivity, profile, record_function

        activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if on_card else [])
        torch.cuda.synchronize() if on_card else None
        with profile(activities=activities) as prof:
            p0 = time.perf_counter()
            while not profiled or time.perf_counter() - p0 < 1.0:
                profiled.append(stream.one(record_function))
                profiled[-1].pop("outputs", None)
        t_read = time.perf_counter()
        summary = tr.summarize(prof, SPANS)
        del prof
        print(f"trace: {len(profiled)} solves, {summary['activities']} device activities, "
              f"read in {time.perf_counter() - t_read:.1f} s", file=sys.stderr, flush=True)

    bad = forbidden_modules()
    if bad:
        raise SystemExit(f"modules of JAX or the JAX package were loaded: {bad}")

    # the program's state is freed before the reference runs
    stream.release()
    tpt.clear_graph_cache()
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    everything = warm + records + profiled
    raised = [r for r in everything if r["error"] is not None or not r.get("finite", False)]
    limits = cell.cfg["limits"]
    cmp = compare(cell, stream, sorted(sample.kept, key=lambda kept: kept[0]), limits,
                  working_dtype=None if on_card else torch.float64)
    print(f"reference: {len(cmp['compared'])} solves {cmp['compared']} in "
          f"{cmp['seconds']:.2f} s", file=sys.stderr, flush=True)
    checks, correct = judge(cmp, limits, len(raised))

    done = [r for r in records if r["error"] is None]
    n_ok = sum(r["ok"] for r in records)
    metrics = {}
    if not trace:
        values = {
            "solves_per_s": n_ok / window_s,
            "solve_s_p95": _quantile_95([r["latency_s"] for r in records]),
            "peak_mem_gib": reserved_peak / GIB,
            "setup_s": setup_s,
        }
        for m in cell.end_to_end:
            metrics[m["name"]] = {"value": values[base_name(m["name"])], "unit": m["unit"]}
    else:
        per_solve = pde.kernel_work(cell.cfg, stream.sizes, torch.finfo(dtype).bits // 8, ctx)
        work = {kernel: w.scaled(len(profiled)) for kernel, w in per_solve.items()}
        lctx = {
            "solves": len(done), "window": done, "counters": counters,
            "retained_bytes": retained, "alloc_peak_bytes": alloc_peak, "trace": summary,
            "profiled": profiled, "work": work, "dtype": cell.cfg["dtype"],
        }
        for m in cell.per_layer:
            v = reader(root, m["name"])(lctx)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    result = {
        "correct": bool(correct),
        "attempted": len(records),
        "failed": len(records) - n_ok,
        "metrics": metrics,
        "device": device_info(cell.chips, max(setup_peak, reserved_peak), on_card),
    }
    if summary is not None:
        result["device"]["busy_s"] = summary["busy_s"]
        result["device"]["window_s"] = summary["window_s"]
        result["breakdown"] = tr.breakdown(summary)
    result["checks"] = checks
    gates = {g: max(r["gates"][g] for r in done) for g in pde.GATES} if done else {}
    rungs = sum(sum(r["rungs"].values()) for r in done)
    print(f"gates, worst over the window: {gates}; rungs {rungs}; "
          f"latency median {statistics.median([r['latency_s'] for r in records]):.5f} s",
          file=sys.stderr, flush=True)
    return result, checks


def device_info(chips: int, peak_bytes: int, on_card: bool) -> dict:
    if not on_card:
        return {"platform": "cpu", "kind": "cpu", "count": 0, "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": chips,
            "memory_peak_bytes": int(peak_bytes)}
