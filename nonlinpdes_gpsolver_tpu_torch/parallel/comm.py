"""Collectives of the mesh path: the counterparts of the ``lax`` collectives.

The JAX package's ``shard_map`` bodies communicate by ``lax.all_gather``,
``lax.psum`` and ``lax.ppermute`` over the mesh axis. Here every rank is a
process, and each of those is a ``torch.distributed`` call on the mesh's
process group (NCCL between cards, gloo on the CPU), made whenever the mesh
has a group, also at size 1. A mesh of one device with no group makes none:
each function is then the identity. So is a group of one while a CUDA graph
is being recorded (:func:`_local`): a recorded Gauss-Newton step at P = 1
holds no collective, and the group's collectives outside it still run.

* :func:`all_gather` stacks every rank's tensor, rank-major;
* :func:`psum` sums the ranks' tensors in rank order on every rank (an
  all-gather and one local sum), so that every rank holds the same bits: the
  replicated quantities of the mesh path (the solution, the losses) must
  not drift apart, or the ranks' control flow would;
* :func:`broadcast` sends the owner's tensor to every rank (the forward
  solve's block of the solution);
* :func:`ppermute` passes a tensor one step along the ring, ``p -> p + 1``.

gloo takes CUDA tensors for ``broadcast`` and ``all_reduce`` only, not for
``all_gather``, ``send`` or ``recv``; so under gloo every collective on a CUDA
tensor (ranks that share one card) goes through a host copy, explicitly.

:func:`agree` makes a host read that decides control flow the same on every
rank: each rank's value is gathered and reduced, so that no rank leaves a
loop, or takes a branch with collectives in it, that another does not.

``COLLECTIVES`` counts the ``torch.distributed`` calls made (for the chip
smoke test, which shows that a group of one still drives its backend).
"""

from __future__ import annotations

import math

import torch
import torch.distributed as dist

from .mesh import Mesh

COLLECTIVES = 0


def _staged(mesh: Mesh, t: torch.Tensor) -> bool:
    return mesh.backend == "gloo" and t.is_cuda


def _count() -> None:
    global COLLECTIVES
    COLLECTIVES += 1


def _local(mesh: Mesh) -> bool:
    """Whether a collective is the identity: no group, or a group of one
    inside a CUDA graph capture (where the rank's own tensor is the
    answer, and no collective is recorded)."""
    if mesh.group is None:
        return True
    return (mesh.size == 1 and mesh.device.type == "cuda"
            and torch.cuda.is_current_stream_capturing())


def all_gather(mesh: Mesh, t: torch.Tensor) -> torch.Tensor:
    """``(P, *t.shape)``: every rank's ``t``, in rank order (``lax.all_gather``)."""
    if _local(mesh):
        return t.unsqueeze(0)
    src = t.detach().contiguous()
    staged = _staged(mesh, src)
    if staged:
        src = src.cpu()
    parts = [torch.empty_like(src) for _ in range(mesh.size)]
    _count()
    dist.all_gather(parts, src, group=mesh.group)
    out = torch.stack(parts)
    return out.to(t.device) if staged else out


def psum(mesh: Mesh, t: torch.Tensor) -> torch.Tensor:
    """The sum of every rank's ``t``, added in rank order (``lax.psum``)."""
    if _local(mesh):
        return t
    parts = all_gather(mesh, t)
    out = parts[0].clone()
    for q in range(1, mesh.size):
        out += parts[q]
    return out


def broadcast(mesh: Mesh, t: torch.Tensor, src: int) -> torch.Tensor:
    """Rank ``src``'s ``t`` on every rank; the other ranks pass a tensor of
    the same shape and dtype, whose values are not read."""
    if _local(mesh):
        return t
    buf = t.detach().contiguous()
    staged = _staged(mesh, buf)
    if staged:  # the receivers' host buffer needs no copy from the card
        buf = buf.cpu() if mesh.rank == src else torch.empty(buf.shape, dtype=buf.dtype)
    _count()
    dist.broadcast(buf, src=dist.get_global_rank(mesh.group, src), group=mesh.group)
    return buf.to(t.device) if staged else buf


def ppermute(mesh: Mesh, t: torch.Tensor) -> torch.Tensor:
    """The ``t`` of rank ``p - 1`` on rank ``p``, around the ring (``lax.ppermute``
    with the permutation ``i -> i + 1``)."""
    if _local(mesh):
        return t
    src = t.detach().contiguous()
    staged = _staged(mesh, src)
    if staged:
        src = src.cpu()
    out = torch.empty_like(src)
    peer = lambda q: dist.get_global_rank(mesh.group, q % mesh.size)  # noqa: E731
    ops = [dist.P2POp(dist.isend, src, peer(mesh.rank + 1), mesh.group),
           dist.P2POp(dist.irecv, out, peer(mesh.rank - 1), mesh.group)]
    _count()
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return out.to(t.device) if staged else out


def agree(mesh: Mesh, value, op: str):
    """The value every rank acts on, for a host read that decides control
    flow: ``value`` (a float or bool) over the ranks, by ``op``: ``'all'``
    and ``'any'`` for flags, ``'min'`` and ``'max'`` (NaN if any rank's value
    is NaN), or ``'first'``, rank 0's value."""
    if op not in ("all", "any", "min", "max", "first"):
        raise ValueError(f"unknown agreement {op!r}")
    if _local(mesh):
        return value
    dev = "cpu" if mesh.backend == "gloo" else mesh.device
    vals = all_gather(mesh, torch.tensor([float(value)], dtype=torch.float64, device=dev))
    vals = vals[:, 0].tolist()
    if op == "all":
        return all(v != 0.0 for v in vals)
    if op == "any":
        return any(v != 0.0 for v in vals)
    if op == "first":
        return type(value)(vals[0])
    if any(math.isnan(v) for v in vals):
        return math.nan
    return min(vals) if op == "min" else max(vals)
