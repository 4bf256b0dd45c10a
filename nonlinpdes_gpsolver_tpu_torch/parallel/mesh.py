"""The device mesh of the mesh path: P ranks of ``torch.distributed``.

Counterpart of ``nonlinpdes_gpsolver_tpu/parallel/mesh.py`` (``make_mesh``
at ``:34``, ``initialize_distributed`` at ``:54``). The JAX package's mesh
is a 1-D ``jax.sharding.Mesh`` whose axis ``'p'`` carries the block-cyclic
row distribution, and its ``shard_map`` bodies run on every device at once.
Here each rank is a process that holds one device and its own shard, and
the collectives of :mod:`.comm` take the place of ``lax``'s. A
:class:`Mesh` records this rank's index, the world size, the process group
and its backend, and the rank's device.

* ``make_mesh(1)`` with no process group is one device alone (the card, or
  the CPU when asked); ``GPSolver``'s ``auto_mesh`` builds it. The mesh
  path then runs without a collective.
* ``make_mesh(P)`` inside an initialized group of P ranks is the group's
  mesh. Its device is ``cuda:{LOCAL_RANK}`` unless ``device=`` names one:
  several ranks may share one card that way (over gloo, whose collectives
  :mod:`.comm` stages through host memory), or run on the CPU.
* A group of one rank is a mesh of size 1 that still calls its group (the
  NCCL bring-up on a machine with one card).
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional

import torch
import torch.distributed as dist

from ..ops.backend import resolve_device


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A 1-D mesh of ``size`` ranks along the axis ``axis``, seen from rank
    ``rank``, whose shard lives on ``device``. ``group`` is the process group
    (``None`` for one device alone) and ``backend`` its backend."""

    device: torch.device
    size: int = 1
    rank: int = 0
    group: Optional[object] = None
    backend: Optional[str] = None
    axis: str = "p"


def device_count() -> int:
    """CUDA devices visible to this process (``mesh.py:30``)."""
    return torch.cuda.device_count()


def _group_device(device, backend: str) -> torch.device:
    """This rank's device: ``device`` if given, else ``cuda:{LOCAL_RANK}``."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available for this rank; pass device='cpu' (with the "
                "gloo backend) to run the mesh on the CPU"
            )
        local = int(os.environ.get("LOCAL_RANK", dist.get_rank() % torch.cuda.device_count()))
        device = torch.device("cuda", local)
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    if backend == "nccl" and device.type != "cuda":
        raise ValueError(f"the nccl backend runs on CUDA devices, not {device}")
    if device.type == "cuda":
        torch.cuda.set_device(device)  # kernels and NCCL launch on the current device
    return device


def make_mesh(n_devices: Optional[int] = None, axis_name: str = "p", device=None) -> Mesh:
    """The 1-D mesh of ``n_devices`` ranks, as ``make_mesh`` of the JAX package.

    Inside an initialized process group, ``n_devices`` defaults to the
    group's size and must equal it (or be 1, for this rank's device alone);
    outside one it defaults to 1, and more raises ``ValueError`` that says
    how to start a group. ``device`` names this rank's device (default: the
    card, ``cuda:{LOCAL_RANK}`` in a group).
    """
    grouped = dist.is_available() and dist.is_initialized()
    world = dist.get_world_size() if grouped else 1
    n_devices = world if n_devices is None else int(n_devices)
    if n_devices < 1:
        raise ValueError(f"a mesh needs at least one device, got {n_devices}")
    if n_devices == 1 and not (grouped and world == 1):
        device = resolve_device(device)
        if device.type == "cuda" and device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())  # as tensors report it
        return Mesh(device, axis=axis_name)
    if not grouped:
        raise ValueError(
            f"a {n_devices}-rank mesh needs an initialized torch.distributed process group "
            f"of {n_devices} ranks: launch with `torchrun --nproc_per_node {n_devices}` and "
            "call parallel.initialize_distributed() (or torch.distributed."
            "init_process_group) before make_mesh"
        )
    if n_devices != world:
        raise ValueError(f"requested a {n_devices}-rank mesh in a process group of {world} ranks")
    backend = str(dist.get_backend())
    return Mesh(_group_device(device, backend), world, dist.get_rank(), dist.group.WORLD,
                backend, axis_name)


def initialize_distributed(init_method: Optional[str] = None,
                           world_size: Optional[int] = None,
                           rank: Optional[int] = None,
                           backend: Optional[str] = None) -> bool:
    """Start the process group; return whether one is running (``:54``).

    Three modes, as in the JAX package:

    * explicit ``world_size > 1``: ``init_process_group`` with ``init_method``
      (for example ``tcp://localhost:29500``), ``world_size`` and ``rank``;
    * all of them ``None`` under ``torchrun`` (``RANK``, ``WORLD_SIZE`` and
      ``MASTER_ADDR`` set, where the JAX package reads ``TPU_WORKER_ID``):
      ``init_process_group`` from those variables;
    * otherwise a no-op that returns False.

    ``backend`` defaults to ``nccl`` (one card per rank); pass ``gloo`` for
    ranks on the CPU or sharing one card. A group that is already running
    is kept. Call it before :func:`make_mesh`. Before
    ``torch.distributed.destroy_process_group()`` on NCCL ranks, drop the
    recorded loops (``clear_graph_cache()``, and any factored problem kept
    without an entry): NCCL's teardown waits for every CUDA graph that
    holds its collectives.
    """
    if dist.is_initialized():
        return True
    backend = backend or "nccl"
    if world_size is not None and world_size > 1:
        dist.init_process_group(backend, init_method=init_method or "env://",
                                world_size=world_size, rank=rank)
        return True
    if (init_method is None and world_size is None and rank is None
            and all(k in os.environ for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR"))):
        dist.init_process_group(backend)
        return True
    return False
