"""The device mesh of the mesh path, on one device.

Counterpart of ``nonlinpdes_gpsolver_tpu/parallel/mesh.py:34`` (``make_mesh``).
The JAX package's mesh is a 1-D ``jax.sharding.Mesh`` whose axis ``'p'``
carries the block-cyclic row distribution of every distributed algorithm.
This slice of the port runs that path at P = 1: a :class:`Mesh` holds one
device (a CUDA card, or the CPU when asked) and the axis name, so that the
several-device form (``torch.distributed``, slice 4 of the port) has a
place to put its process group. A mesh of more than one device raises
``NotImplementedError``; ``initialize_distributed`` comes with slice 4.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from ..ops.backend import resolve_device


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A 1-D device mesh: ``devices`` along the axis ``axis``."""

    devices: Tuple[torch.device, ...]
    axis: str = "p"

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def device(self) -> torch.device:
        """The mesh's one device (the mesh path runs at P = 1)."""
        check_one_device(self)
        return self.devices[0]


def _one_device_only(n: int) -> None:
    if n != 1:
        raise NotImplementedError(
            f"a {n}-device mesh runs the mesh path across devices, which is "
            "slice 4 of the port (torch.distributed); this slice runs it on one device"
        )


def check_one_device(mesh: Mesh) -> None:
    """Raise ``NotImplementedError`` unless ``mesh`` has one device."""
    _one_device_only(mesh.size)


def device_count() -> int:
    """CUDA devices visible to this process (``mesh.py:30``)."""
    return torch.cuda.device_count()


def make_mesh(n_devices: Optional[int] = None, axis_name: str = "p", device=None) -> Mesh:
    """The 1-D mesh over ``n_devices`` devices (default: every visible card,
    or the CPU when ``device="cpu"``), as ``make_mesh`` of the JAX package.

    Only ``n_devices = 1`` is ported: more raises ``NotImplementedError``.
    """
    device = resolve_device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())  # as tensors report it
    visible = device_count() if device.type == "cuda" else 1
    n_devices = visible if n_devices is None else n_devices
    if n_devices < 1:
        raise ValueError(f"a mesh needs at least one device, got {n_devices}")
    if device.type == "cuda" and n_devices > visible:
        raise ValueError(
            f"requested a {n_devices}-device mesh but only {visible} CUDA devices are visible"
        )
    _one_device_only(n_devices)
    return Mesh((device,), axis_name)
