#!/usr/bin/env python3
"""Where the Gram kernel K1 spends its time, on one CUDA card.

    python3 scripts/torch_k1_split.py     # from the repository root

Builds ``csrc/gram_tile.cu`` three times into ``_build/split/`` (as it is,
with ``-DK1_SPLIT_NO_STORE`` and with ``-DK1_SPLIT_NO_EVAL``) and times each
build (CUDA events, as ``chip_smoke.py`` times) on four f32 launches of the
16,200-row solve's shapes: the training Gram, the 3,600-row test
cross-Gram, and the 7,800^2 Laplacian x Laplacian and identity x identity
blocks as one-block launches. The build as it is is checked against the
plain version first. Prints one JSON line, then the card's name and power
limit.
"""

import ctypes
import json
import os
import subprocess
import sys

sys.path.insert(0, os.getcwd())
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
import nonlinpdes_gpsolver_tpu_torch as tpt  # noqa: E402
from nonlinpdes_gpsolver_tpu_torch.ops import _build, gram_tile  # noqa: E402
from nonlinpdes_gpsolver_tpu_torch.ops.operators import identity, laplacian  # noqa: E402

VARIANTS = {"kernel": [], "no_store": ["-DK1_SPLIT_NO_STORE"], "no_eval": ["-DK1_SPLIT_NO_EVAL"]}


def build(tag, defines, source=_build.CSRC / "gram_tile.cu"):
    """Compile ``source`` with ``defines`` into ``_build/split/``; returns the
    library's path and the ptxas lines of the build (registers, spills)."""
    out_dir = _build.BUILD_DIR / "split"
    out_dir.mkdir(parents=True, exist_ok=True)
    out = out_dir / f"libgram_tile_{tag}.so"
    cmd = [_build._nvcc(), *_build.NVCC_FLAGS, *defines, "-o", str(out), str(source)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"nvcc failed on {source} ({tag}):\n{proc.stderr}")
    log = (proc.stdout + proc.stderr).splitlines()
    return str(out), [ln.strip() for ln in log
                      if "entry function" in ln or "registers" in ln or "spill" in ln]


def use(lib_path):
    """Point the wrapper at one build (the plans' packed parameters stay:
    every build shares the parameter layout)."""
    _build.load_library = lambda name: ctypes.CDLL(lib_path)
    gram_tile._kernel_lib.cache_clear()


def main():
    if not torch.cuda.is_available():
        raise SystemExit("torch_k1_split: no CUDA card")
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    dom = torch.rand((7800, 2), generator=gen, device=dev)
    bdy = torch.rand((600, 2), generator=gen, device=dev)
    X_test = torch.rand((3600, 2), generator=gen, device=dev)
    k = tpt.SquaredExponential.gaussian(0.2)
    obs = (tpt.ops.Observable("domain", laplacian()), tpt.ops.Observable("domain", identity()),
           tpt.ops.Observable("boundary", identity()))
    sizes = (7800, 7800, 600)
    cases = {
        "training Gram 16200^2": (gram_tile.gram_plan(k, obs, sizes), [dom, bdy]),
        "cross-Gram 3600x16200": (gram_tile.cross_plan(k, identity(), 3600, obs, sizes),
                                  [X_test, dom, bdy]),
        "lap x lap 7800^2": (gram_tile.pair_plan(k, laplacian(), laplacian(), 7800, 7800),
                             [dom, dom]),
        "id x id 7800^2": (gram_tile.pair_plan(k, identity(), identity(), 7800, 7800),
                           [dom, dom]),
    }
    libs = {tag: build(tag, defs)[0] for tag, defs in VARIANTS.items()}
    use(libs["kernel"])
    for name, (plan, sets) in cases.items():
        got = plan.run(sets)
        ref = torch.zeros_like(got)
        plan._plain(sets, ref)
        rel, _ = cs.blockwise_rel_err(plan, got, ref)
        cs.check(rel <= 1e-5, f"{name}: {rel:.3e} of the block's scale")
    bufs = {name: torch.empty(plan.shape, device=dev) for name, (plan, _) in cases.items()}
    ms = {}
    for tag in [*libs, *reversed(list(libs))]:  # each build twice, in turns
        use(libs[tag])
        for name, (plan, sets) in cases.items():
            t = cs.time_ms(lambda: plan.run(sets, out=bufs[name]), 20)
            ms.setdefault(name, {}).setdefault(tag, []).append(t)
    bounds = {name: cs.k1_bound_ms(plan, "float32")[0] for name, (plan, _) in cases.items()}
    print(json.dumps({"ms": ms, "bound_ms": bounds}))
    print(cs.smi("name,power.limit"))


if __name__ == "__main__":
    main()
