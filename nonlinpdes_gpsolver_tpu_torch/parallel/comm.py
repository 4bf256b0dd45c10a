"""Collectives of the mesh path: the counterparts of the ``lax`` collectives.

The JAX package's ``shard_map`` bodies communicate by ``lax.all_gather``,
``lax.psum`` and ``lax.ppermute`` over the mesh axis. Here every rank is a
process, and each of those is a ``torch.distributed`` call on the mesh's
process group (NCCL between cards, gloo on the CPU), made whenever the mesh
has a group, also at size 1. A mesh of one device with no group makes none:
each function is then the identity.

* :func:`all_gather` stacks every rank's tensor, rank-major;
* :func:`psum` sums the ranks' tensors in rank order on every rank (an
  all-gather and one local sum), so that every rank holds the same bits: the
  replicated quantities of the mesh path (the solution, the losses) must
  not drift apart, or the ranks' control flow would;
* :func:`broadcast` sends the owner's tensor to every rank (the forward
  solve's block of the solution);
* :func:`ppermute` passes a tensor one step along the ring, ``p -> p + 1``.

Under NCCL each of them may be called on a stream that records a CUDA
graph: the graph then holds the NCCL kernels, and every replay
communicates again (the JAX package's compiled loop with its collectives
inside). NCCL cannot set up a communicator inside a recording, so the
eager warm-up of a recorded step makes every collective of the step
first, the ring's point-to-point exchange included. A group of one
records its NCCL calls too.

gloo takes CUDA tensors for ``broadcast`` and ``all_reduce`` only, not for
``all_gather``, ``send`` or ``recv``; so under gloo every collective on a CUDA
tensor (ranks that share one card) goes through a host copy, explicitly.
No graph can hold such a copy: a staged collective raises while a graph is
being recorded, and the mesh path does not record there
(``solvers/distributed.py::_records``).

:func:`agree` makes a host read that decides control flow the same on every
rank: each rank's value is gathered and reduced, so that no rank leaves a
loop, or takes a branch with collectives in it, that another does not.
:func:`agree_device` is the same reduction on a device flag, by a
collective that a graph can hold, and returns a tensor: the mesh loop
agrees its exit and step flags with it, and the host then reads a flag
that is already the same on every rank.

``COLLECTIVES`` counts the ``torch.distributed`` calls made eagerly,
``RECORDED`` those recorded into a CUDA graph (each then runs at every
replay of its graph) and ``AGREEMENTS`` the host agreements
(:func:`agree`): the chip smoke test shows with them that a group of one
drives its backend and records it, and the tests count the host
collectives of a loop.
"""

from __future__ import annotations

import math

import torch
import torch.distributed as dist

from .mesh import Mesh

COLLECTIVES = 0
RECORDED = 0
AGREEMENTS = 0

# the gather into one tensor (named all_gather_single in newer torch)
_gather_into = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor


def reset_counts() -> None:
    global COLLECTIVES, RECORDED, AGREEMENTS
    COLLECTIVES = RECORDED = AGREEMENTS = 0


def _recording(t: torch.Tensor) -> bool:
    return t.is_cuda and torch.cuda.is_current_stream_capturing()


def _staged(mesh: Mesh, t: torch.Tensor) -> bool:
    if mesh.backend != "gloo" or not t.is_cuda:
        return False
    if _recording(t):
        raise RuntimeError("a gloo collective on a CUDA tensor goes through host memory, "
                           "which a CUDA graph cannot record")
    return True


def _count(t: torch.Tensor) -> None:
    global COLLECTIVES, RECORDED
    if _recording(t):
        RECORDED += 1
    else:
        COLLECTIVES += 1


def _local(mesh: Mesh) -> bool:
    """Whether a collective is the identity: a mesh with no group."""
    return mesh.group is None


def all_gather(mesh: Mesh, t: torch.Tensor) -> torch.Tensor:
    """``(P, *t.shape)``: every rank's ``t``, in rank order (``lax.all_gather``)."""
    if _local(mesh):
        return t.unsqueeze(0)
    src = t.detach().contiguous()
    staged = _staged(mesh, src)
    if staged:
        src = src.cpu()
    _count(t)
    out = src.new_empty((mesh.size * src.numel(),))  # one call into one tensor: no copies out
    _gather_into(out, src.reshape(-1), group=mesh.group)
    out = out.view(mesh.size, *src.shape)
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
    _count(t)
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
    _count(t)
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return out.to(t.device) if staged else out


def agree(mesh: Mesh, value, op: str):
    """The value every rank acts on, for a host read that decides control
    flow: ``value`` (a float or bool) over the ranks, by ``op``: ``'all'``
    and ``'any'`` for flags, ``'min'`` and ``'max'`` (NaN if any rank's value
    is NaN), ``'first'``, rank 0's value, or ``'same'``, ``value`` if every
    rank holds it and else ``None``."""
    global AGREEMENTS
    if op not in ("all", "any", "min", "max", "first", "same"):
        raise ValueError(f"unknown agreement {op!r}")
    if _local(mesh):
        return value
    AGREEMENTS += 1
    dev = "cpu" if mesh.backend == "gloo" else mesh.device
    vals = all_gather(mesh, torch.tensor([float(value)], dtype=torch.float64, device=dev))
    vals = vals[:, 0].tolist()
    if op == "all":
        return all(v != 0.0 for v in vals)
    if op == "any":
        return any(v != 0.0 for v in vals)
    if op == "first":
        return type(value)(vals[0])
    if op == "same":
        return value if all(v == vals[0] for v in vals) else None
    if any(math.isnan(v) for v in vals):
        return math.nan
    return min(vals) if op == "min" else max(vals)


def agree_device(mesh: Mesh, t: torch.Tensor, op: str) -> torch.Tensor:
    """:func:`agree` on the device: ``t`` (a flag, a code or a vector) over
    the ranks by ``op`` (``'any'`` or ``'max'``, NaN if any rank's is NaN,
    or ``'first'``, rank 0's), a tensor of ``t``'s shape and dtype on every
    rank, by one :func:`all_gather` and no host read, so that a graph can
    record it. Without a group, ``t`` itself."""
    if op not in ("any", "max", "first"):
        raise ValueError(f"unknown device agreement {op!r}")
    if _local(mesh):
        return t
    parts = all_gather(mesh, t)
    if op == "first":
        return parts[0]
    return parts.any(0) if t.dtype == torch.bool else parts.amax(0)  # amax: NaN wins
