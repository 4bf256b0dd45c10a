"""Checkpoint and resume for factorizations and Gauss-Newton state.

Counterpart of ``nonlinpdes_gpsolver_tpu/utils/checkpoint.py``, in its file
format, so that either package reloads the other's file: one
``np.savez_compressed`` archive whose keys are ``factor__{block}``,
``inv_factor__{block}``, ``col_scale__{block}`` (dense path),
``factor_local__{block}`` (mesh path), ``z``, ``losses`` and
``converged_finite``, plus ``meta_json``, the JSON of ``problem``,
``blocks``, ``nugget_scales``, ``has_inverse``, ``has_col_scales``,
``has_state`` and, for the mesh path, ``kind: "distributed"`` with each
block's ``block``, ``n``, ``n_pad``, ``axis`` and ``mesh_size``. The caller
rebuilds the problem (points and data are cheap); a load checks the
problem's name and each block's size against the file and raises
``ValueError`` on a mismatch. Loads go to the problem's device, in its dtype
(a JAX package f64 file loads into f32 on the card).

What the port holds and the format does not, bridged:

* ``rungs`` (the tenfold nugget escalations of each block) is written as the
  extra meta key ``rungs``, which the JAX loader ignores. A file without it
  gets ``round(log10(s))`` of each block's ``nugget_scales`` entry ``s``: the
  escalation starts at scale 1 for any nugget of at least 4 eps of the dtype,
  and for a smaller nugget this count includes the start above 1;
* ``GNState.cg_iters`` is not in the file and loads as zeros;
* the mesh path's ``BlockCyclicFactor.diag_inv`` (the refined inverses of
  the diagonal blocks, which the triangular solves read) is written as the
  extra key ``diag_inv__{block}``, the global ``(nb, B, B)`` array, which the
  JAX loader ignores, so that a resumed solve reproduces the saved one: the
  fused factorization takes them from its superblock inverses, and
  inverting the stored float32 blocks again gives other bits. A file
  without the key (the JAX package's) gets them rebuilt on load by
  ``parallel/cholesky.py::diag_inverses``;
  ``DistributedFactoredProblem.quality`` and ``stats`` load empty;
* across ranks, the file holds the global ``(nb, B, n_pad)`` array in the
  saving mesh's slot order: :func:`save_distributed_state` gathers it to
  rank 0 one row block at a time through host memory, and every rank of a
  load reads the file and takes its own blocks
  (``parallel/cholesky.py::deal_saved_blocks``), on a mesh of any size that
  divides ``nb``.

A loaded factor is a factorization like any other for the Gauss-Newton
loops shared by problems of one structure (``solvers/_reuse.py``): it is
read into the storage of a released problem of its layout, whose recorded
loop it then replays, or its tensors make a new entry, or it is a guest
of its layout's guest entry.
"""

from __future__ import annotations

import functools
import json
from pathlib import Path
from typing import Optional, Tuple

import numpy as np
import torch

from ..models.spec import CollocationProblem
from ..ops.linalg import rungs_climbed
from ..parallel import comm
from ..parallel.cholesky import BlockCyclicFactor, deal_saved_blocks, diag_inverses, pad_to_blocks
from ..parallel.mesh import Mesh
from ..solvers import _reuse
from ..solvers.distributed import (
    DistributedFactoredProblem,
    mesh_key,
    mesh_storage,
    mesh_tensors,
    mesh_view,
)
from ..solvers.gn import (
    FactoredProblem,
    GNState,
    dense_role_storage,
    dense_roles,
    dense_storage,
    dense_tensors,
    dense_view,
)


def _host(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def _state_payload(state: GNState) -> dict:
    return {"z": _host(state.z), "losses": _host(state.losses),
            "converged_finite": _host(torch.as_tensor(state.converged_finite))}


def _settle(fp) -> None:
    """Resolve ``fp``'s pending quality verdicts (``defer_quality``) before
    its scales and rungs are written: a factor whose verdict failed is not
    saved."""
    bad, _ = fp.resolve_pending()
    if bad:
        raise FloatingPointError(
            f"problem {fp.problem.name!r}: the deferred quality verdict failed for {bad}; "
            "solve with GPSolver, which factors again, before saving"
        )


def _write(path, meta: dict, payload: dict) -> None:
    payload["meta_json"] = np.frombuffer(json.dumps(meta).encode(), dtype=np.uint8)
    np.savez_compressed(Path(path), **payload)


def save_solver_state(path, fp: FactoredProblem, state: Optional[GNState] = None) -> None:
    """Write a dense-path :class:`~..solvers.gn.FactoredProblem` (and a
    Gauss-Newton state) to ``path``, in the JAX package's format. Pending
    deferred verdicts are read first; a failed one refuses the save."""
    _settle(fp)
    meta = {
        "problem": fp.problem.name,
        "blocks": [b.name for b in fp.problem.blocks],
        "nugget_scales": {k: float(v) for k, v in fp.nugget_scales.items()},
        "has_inverse": sorted(fp.inv_factors),
        "has_col_scales": sorted(fp.col_scales),
        "has_state": state is not None,
        "rungs": {k: int(v) for k, v in fp.rungs.items()},
    }
    payload = {}
    for name, L in fp.factors.items():
        payload[f"factor__{name}"] = _host(L)
    for name, Li in fp.inv_factors.items():
        payload[f"inv_factor__{name}"] = _host(Li)
    for name, cs in fp.col_scales.items():
        payload[f"col_scale__{name}"] = _host(cs)
    if state is not None:
        payload.update(_state_payload(state))
    _write(path, meta, payload)


def _global_blocks(fac: BlockCyclicFactor) -> Optional[np.ndarray]:
    """The factor's global ``(nb, B, n_pad)`` array in its mesh's slot order,
    on rank 0 (``None`` on the other ranks): rank q's shard goes to slots
    ``q nbl .. (q + 1) nbl``, gathered one slot a step through host memory,
    so that no card holds more than ``P`` row blocks beyond its shard."""
    mesh, local = fac.mesh, fac.local
    if mesh.size == 1:
        return _host(local)
    nbl = local.shape[0]
    out = None
    for j in range(nbl):
        parts = _host(comm.all_gather(mesh, local[j]))  # (P, B, n_pad): slot j of every rank
        if mesh.rank == 0:
            if out is None:
                out = np.empty((nbl * mesh.size, *parts.shape[1:]), dtype=parts.dtype)
            out[j::nbl] = parts
    return out


def save_distributed_state(path, dfp: DistributedFactoredProblem,
                           state: Optional[GNState] = None) -> None:
    """Write a mesh-path :class:`~..solvers.distributed.DistributedFactoredProblem`
    (and a Gauss-Newton state) to ``path``, in the JAX package's format.

    Every rank of the mesh calls it (the gather is a collective); rank 0
    writes the file, and a barrier follows, so that the file is whole on
    every rank's return. The layout saved is the mesh's own; a load onto
    another mesh size re-deals it (:func:`load_distributed_state`).
    Pending deferred verdicts are read first; a failed one refuses the
    save."""
    _settle(dfp)
    meta = {
        "problem": dfp.problem.name,
        "blocks": [],
        "nugget_scales": {k: float(v) for k, v in dfp.nugget_scales.items()},
        "has_col_scales": sorted(dfp.col_scales),
        "has_state": state is not None,
        "kind": "distributed",
        "rungs": {k: int(v) for k, v in dfp.rungs.items()},
    }
    payload = {}
    for name, fac in dfp.factors.items():
        meta["blocks"].append({"name": name, "block": fac.block, "n": fac.n, "n_pad": fac.n_pad,
                               "axis": fac.axis, "mesh_size": fac.mesh.size})
        payload[f"factor_local__{name}"] = _global_blocks(fac)
        if fac.diag_inv is not None and dfp.mesh.rank == 0:
            payload[f"diag_inv__{name}"] = _host(fac.diag_inv)
    for name, cs in dfp.col_scales.items():
        payload[f"col_scale__{name}"] = _host(cs)
    if state is not None:
        payload.update(_state_payload(state))
    mesh = dfp.mesh
    if mesh.rank == 0:
        _write(path, meta, payload)
    del payload
    if mesh.group is not None:
        torch.distributed.barrier(group=mesh.group)


def _read_meta(data, problem: CollocationProblem) -> dict:
    meta = json.loads(bytes(data["meta_json"]).decode())
    if meta["problem"] != problem.name:
        raise ValueError(f"checkpoint is for problem {meta['problem']!r}, got {problem.name!r}")
    return meta


def _block_size(problem: CollocationProblem, block) -> int:
    return sum(int(problem.points[o.points].shape[0]) for o in block.observables)


def _rungs(meta: dict) -> dict:
    if "rungs" in meta:
        return {k: int(v) for k, v in meta["rungs"].items()}
    return {k: max(0, rungs_climbed(float(s), 1.0)) for k, s in meta["nugget_scales"].items()}


def _read_state(data, meta: dict, to) -> Optional[GNState]:
    if not meta["has_state"]:
        return None
    losses = to(data["losses"])
    return GNState(z=to(data["z"]), losses=losses,
                   converged_finite=torch.as_tensor(bool(data["converged_finite"]),
                                                    device=losses.device),
                   cg_iters=torch.zeros(losses.shape[0], dtype=torch.int64))


def _converter(problem: CollocationProblem):
    def to(a):
        return torch.as_tensor(np.asarray(a), device=problem.device).to(problem.dtype)

    return to


def _into(out: dict, to):
    """``put(block, role, a)``: ``a`` (an array, or a tensor already on the
    problem's device in its dtype) written into ``out[block][role]`` (a
    claimed entry's storage) where there is one."""

    def put(name, role, a):
        buf = out.get(name, {}).get(role)
        if buf is None:
            return a if torch.is_tensor(a) else to(a)
        return buf.copy_(a if torch.is_tensor(a) else torch.as_tensor(np.asarray(a)))

    return put


def load_solver_state(path, problem: CollocationProblem
                      ) -> Tuple[FactoredProblem, Optional[GNState]]:
    """Rebuild a :class:`~..solvers.gn.FactoredProblem` for ``problem`` (and
    the saved Gauss-Newton state, or ``None``) from a dense-path checkpoint
    of either package."""
    to = _converter(problem)
    with np.load(Path(path)) as data:
        meta = _read_meta(data, problem)
        for b in problem.blocks:
            if b.name not in meta["blocks"]:
                raise ValueError(f"checkpoint missing block {b.name!r}")
            n_file, n_expected = data[f"factor__{b.name}"].shape[0], _block_size(problem, b)
            if n_file != n_expected:
                raise ValueError(f"block {b.name!r}: factor size {n_file} != problem size "
                                 f"{n_expected} (points changed?)")
        roles = {b.name: (_block_size(problem, b), b.name in meta["has_inverse"],
                          b.name in meta.get("has_col_scales", [])) for b in problem.blocks}
        key = _reuse.layout_key(problem, {name: dense_roles(*r) for name, r in roles.items()})
        with _reuse.claimed(key) as entry:
            if entry is not None:
                out = entry.outputs()
            elif key is not None:  # the storage a factorization of the layout makes
                out = {name: dense_storage(n, inverse, problem.dtype, problem.device, scaled)
                       for name, (n, inverse, scaled) in roles.items()}
            else:
                out = {}
            put = _into(out, to)
            factors, inv_factors, col_scales = {}, {}, {}
            for b in problem.blocks:
                factors[b.name] = put(b.name, "L", data[f"factor__{b.name}"])
                if b.name in meta["has_inverse"]:
                    inv_factors[b.name] = put(b.name, "inv", data[f"inv_factor__{b.name}"])
                if b.name in meta.get("has_col_scales", []):
                    col_scales[b.name] = put(b.name, "d", data[f"col_scale__{b.name}"])
            fp = FactoredProblem(
                problem=problem, factors=factors, inv_factors=inv_factors,
                nugget_scales={k: float(v) for k, v in meta["nugget_scales"].items()},
                col_scales=col_scales, rungs=_rungs(meta),
            )
            _reuse.settle(fp, key, entry, dense_tensors(fp), dense_view, dense_role_storage)
        state = _read_state(data, meta, to)
    return fp, state


def load_distributed_state(path, problem: CollocationProblem, mesh: Mesh, axis: str = "p"
                           ) -> Tuple[DistributedFactoredProblem, Optional[GNState]]:
    """Rebuild a :class:`~..solvers.distributed.DistributedFactoredProblem` on
    ``mesh`` (and the saved Gauss-Newton state, or ``None``) from a mesh-path
    checkpoint of either package.

    Every rank of the mesh calls it: each reads the file and takes its own
    row blocks, re-dealt when the file was saved on a mesh of another size
    (``nb`` must divide by the new size), then the diagonal-block inverses
    are read from the file, or rebuilt (one ``all_gather``) where it holds
    none."""
    to = _converter(problem)
    with np.load(Path(path)) as data:
        meta = _read_meta(data, problem)
        if meta.get("kind") != "distributed":
            raise ValueError("not a distributed checkpoint")
        by_name = {bm["name"]: bm for bm in meta["blocks"]}
        for b in problem.blocks:
            bm = by_name.get(b.name)
            if bm is None:
                raise ValueError(f"checkpoint missing block {b.name!r}")
            n_expected = _block_size(problem, b)
            if bm["n"] != n_expected:
                raise ValueError(f"block {b.name!r}: factor size {bm['n']} != problem size "
                                 f"{n_expected} (points changed?)")
        key, block = None, {int(by_name[b.name]["block"]) for b in problem.blocks}
        if len(block) == 1:  # the fused factor's layout (mesh_roles)
            block = block.pop()
            if all(by_name[b.name]["n_pad"] == pad_to_blocks(by_name[b.name]["n"], block, mesh.size)
                   and b.name in meta.get("has_col_scales", []) for b in problem.blocks):
                key = mesh_key(problem, mesh, axis, block)
        with _reuse.claimed(key, mesh) as entry:
            put = _into(entry.outputs() if entry is not None else {}, to)
            factors, col_scales = {}, {}
            for b in problem.blocks:
                bm = by_name[b.name]
                local = put(b.name, "local",
                            deal_saved_blocks(data[f"factor_local__{b.name}"], bm["mesh_size"],
                                              mesh))
                key_inv = f"diag_inv__{b.name}"
                diag_inv = put(b.name, "diag_inv",
                               data[key_inv] if key_inv in data.files
                               else diag_inverses(local, mesh, axis, int(bm["block"])))
                factors[b.name] = BlockCyclicFactor(local, mesh, axis, int(bm["block"]),
                                                    int(bm["n"]), int(bm["n_pad"]), diag_inv)
                if b.name in meta.get("has_col_scales", []):
                    col_scales[b.name] = put(b.name, "d", data[f"col_scale__{b.name}"])
            dfp = DistributedFactoredProblem(
                problem=problem, factors=factors, col_scales=col_scales,
                nugget_scales={k: float(v) for k, v in meta["nugget_scales"].items()},
                rungs=_rungs(meta), quality={}, stats={},
            )
            _reuse.settle(dfp, key, entry, mesh_tensors(dfp),
                          functools.partial(mesh_view, mesh=mesh, axis=axis, block=block),
                          mesh_storage, mesh)
        state = _read_state(data, meta, to)
    return dfp, state
