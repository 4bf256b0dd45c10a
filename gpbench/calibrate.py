"""Readings that set a cell's limits: the program's gaps and the control's.

    python3 gpbench/calibrate.py --workload <cell> --seeds 1 2 3 --solves 16 \\
        [--program] [--control] [--out FILE]

In one process on the card. ``--program``: set-up as a run, then for each
seed the first ``--solves`` problems of its stream through the program,
each compared with the plain reference in float64 (the numbers a run
compares, over all those solves). ``--control``: for each seed the same
problems solved by the reference in the precision just below the
configuration's (``reference/linalg.py``: TF32 products), put in the
program's place and compared with the float64 reference by the same
``harness.compare``. Prints one JSON line per seed and kind, with the gaps
and the ``correct`` that ``harness.judge`` gives them (and appends them to
``--out``).
"""

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--solves", type=int, default=4)
    ap.add_argument("--program", action="store_true")
    ap.add_argument("--control", action="store_true")
    ap.add_argument("--out")
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT))
    import torch

    import nonlinpdes_gpsolver_tpu_torch as tpt
    from gpbench.harness import Cell, Stream, compare, judge, no_span, warm_up
    from gpbench.reference.linalg import Precision
    from nonlinpdes_gpsolver_tpu_torch.ops import graphs

    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    cell = Cell(ROOT, args.workload)
    dev, dtype = torch.device("cuda"), getattr(torch, cell.cfg["dtype"])
    ctx = cell.pde.setup(cell.cfg, dev, dtype)
    stream = Stream(tpt, cell, args.seeds[0], dev, dtype, ctx)
    limits = cell.cfg["limits"]

    def emit(kind, seed, cmp, **extra):
        _, correct = judge(cmp, limits)
        row = {"workload": args.workload, "kind": kind, "seed": seed, **cmp["gaps"],
               "correct": correct, "reference_s": cmp["seconds"], **extra}
        print(json.dumps(row), flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(json.dumps(row) + "\n")

    if args.program:
        warm_up(stream, graphs)
        for seed in args.seeds:
            stream.seed, stream.k = seed, 0
            recs = [stream.one(no_span) for _ in range(args.solves)]
            sample = [(r["k"], r.pop("outputs")) for r in recs if "outputs" in r]
            emit("program", seed, compare(cell, stream, sample, limits),
                 gates=[r.get("gates") for r in recs], rungs=[r.get("rungs") for r in recs],
                 errors=[r["error"] for r in recs if r["error"]])
        stream.release()
        tpt.clear_graph_cache()
        torch.cuda.empty_cache()
    if args.control:
        for seed in args.seeds:
            stream.seed = seed
            sample = [(k, None) for k in range(args.solves)]
            emit("control", seed, compare(cell, stream, sample, limits, control=Precision("tf32")))
    return 0


if __name__ == "__main__":
    sys.exit(main())
