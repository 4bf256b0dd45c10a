#!/usr/bin/env python3
"""Whether each collective of the mesh path records into a CUDA graph over NCCL.

    python3 scripts/torch_nccl_capture_probe.py        # one rank per visible card

Spawns one rank per visible card, joined by NCCL. On every rank, each of
``parallel/comm.py``'s ``all_gather``, ``psum``, ``broadcast`` (from the last
rank), ``ppermute`` (around the ring) and ``agree_device`` runs eagerly
twice (on an input and on the input plus 10), then is recorded alone as a
CUDA graph on the recorder's capture stream and replayed on both inputs:
each replay must equal its eager result bitwise. Prints one JSON line a
rank (``ok`` or the error of each collective, ``comm.RECORDED``), then the
card's name and power limit. Exit code 1 if a collective failed on any
rank.
"""

import json
import os
import socket
import subprocess
import sys
import traceback

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def rank_main(rank, world, port, out_dir):
    os.environ.update(RANK=str(rank), LOCAL_RANK=str(rank), WORLD_SIZE=str(world),
                      MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
    import torch
    import torch.distributed as dist

    from nonlinpdes_gpsolver_tpu_torch.ops.graphs import Recorder
    from nonlinpdes_gpsolver_tpu_torch.parallel import comm, initialize_distributed, make_mesh

    initialize_distributed(backend="nccl")
    mesh = make_mesh(world)
    x = torch.arange(6, dtype=torch.float32, device=mesh.device).reshape(2, 3) + 100 * rank
    cases = {
        "all_gather": lambda: comm.all_gather(mesh, x),
        "psum": lambda: comm.psum(mesh, x),
        "broadcast": lambda: comm.broadcast(mesh, x.clone(), world - 1),
        "ppermute": lambda: comm.ppermute(mesh, x),
        "agree_device": lambda: comm.agree_device(mesh, (x > 104).any(), "any"),
    }
    out = {"rank": rank}
    rec = Recorder(mesh.device)
    for name, fn in cases.items():
        try:
            with rec.scope():
                want = fn().clone()
                x.add_(10.0)
                want2 = fn().clone()
                x.sub_(10.0)
                result = []
                rec.capture(name, lambda: result.append(fn()))
                rec.replay(name)
                ok = bool(torch.equal(result[0], want))
                x.add_(10.0)
                rec.replay(name)
                ok = ok and bool(torch.equal(result[0], want2))
                x.sub_(10.0)
            torch.cuda.synchronize()
            out[name] = "ok" if ok else "differs from its eager result"
        except Exception as e:  # reported per collective, then the probe fails
            traceback.print_exc()
            out[name] = repr(e)[:600]
        dist.barrier()
    out["recorded"] = comm.RECORDED
    rec.graphs.clear()  # NCCL's teardown waits for every graph that holds its collectives
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as fh:
        json.dump(out, fh)
    dist.destroy_process_group()


def main():
    import tempfile

    import torch
    import torch.multiprocessing as mp

    if not torch.cuda.is_available():
        raise SystemExit("no CUDA card is visible")
    world = torch.cuda.device_count()
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    with tempfile.TemporaryDirectory() as tmp:
        mp.spawn(rank_main, args=(world, port, tmp), nprocs=world, join=True)
        ranks = [json.load(open(os.path.join(tmp, f"rank{r}.json"))) for r in range(world)]
    for r in ranks:
        print(json.dumps(r), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    failed = [(r["rank"], k) for r in ranks for k, v in r.items() if isinstance(v, str) and v != "ok"]
    if failed:
        raise SystemExit(f"collectives that did not record: {failed}")


if __name__ == "__main__":
    main()
