#!/usr/bin/env python3
"""Run ``chip_smoke.py``'s ``gn_graphs`` phase alone on the card.

    python3 scripts/torch_gn_graphs.py            # mesh case at 42,500 Gram rows
    python3 scripts/torch_gn_graphs.py --small    # mesh case cut to 2,000 + 400 points

Builds the Gram kernel, then records and replays the Gauss-Newton loop of
each case against its eager steps (see ``chip_smoke.gn_graphs``) and prints
one JSON line per case: seconds, host reads, replays, captures and graph
pool bytes of the eager, recorded and replayed runs, and z against the
eager run. Writes the whole result to ``--out`` if given.
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--small", action="store_true", help="cut the mesh case to 2,000 + 400 points")
    ap.add_argument("--out", help="write the result as JSON to this file")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("torch_gn_graphs: no CUDA card")
    import chip_smoke
    import nonlinpdes_gpsolver_tpu_torch as tpt
    from nonlinpdes_gpsolver_tpu_torch.ops import gram_tile

    card = chip_smoke.smi("name,power.limit")
    print(json.dumps({"card": card, "torch": torch.__version__, "cuda": torch.version.cuda}))
    t0 = time.perf_counter()
    gram_tile._kernel_lib()
    out = chip_smoke.gn_graphs(tpt, torch.device("cuda"), mesh_full=not args.small)
    for name, row in out.items():
        print(json.dumps({"case": name, **row}), flush=True)
    print(json.dumps({"seconds": time.perf_counter() - t0, "card": card}))
    if args.out:
        with open(args.out, "w") as fh:
            json.dump({"card": card, "cases": out}, fh, indent=1)


if __name__ == "__main__":
    main()
