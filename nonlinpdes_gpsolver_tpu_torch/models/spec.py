"""Declarative collocation-problem specification.

Counterpart of ``nonlinpdes_gpsolver_tpu/models/spec.py``. A problem is
data: one or more :class:`GPBlock` s (a kernel, the observed linear
functionals, and a ``residual`` map from the latent vector ``z`` to the
stacked functional values, written in torch so that ``torch.func``
linearizes it) plus optional weighted :class:`Misfit` penalties.

Total loss:  ``sum_b ||L_b^{-1} F_b(z)||^2 + sum_m w_m ||r_m(z)||^2``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from ..ops.assembly import Observable
from ..ops.kernels import SquaredExponential
from ..utils.tracing import Record


@dataclasses.dataclass(frozen=True)
class GPBlock:
    """One GP prior: kernel + observed functionals + residual map.

    ``residual(z, data)`` returns the functional values stacked in the order
    of ``observables`` (the Gram matrix row order).
    """

    name: str
    kernel: SquaredExponential
    observables: Tuple[Observable, ...]
    residual: Callable[[torch.Tensor, Any], torch.Tensor]


@dataclasses.dataclass(frozen=True)
class Misfit:
    """Weighted penalty ``weight * ||r(z)||^2`` added to the loss."""

    name: str
    residual: Callable[[torch.Tensor, Any], torch.Tensor]
    weight: float


@dataclasses.dataclass(frozen=True)
class CollocationProblem:
    """A complete GP collocation problem over point sets ``points``.

    Every tensor (points, data) lies on one device in one dtype; the solver
    runs there. ``latent_dim`` is the length of the free latent vector ``z``.
    ``trace`` is the :class:`..utils.tracing.Record` its model constructor
    started (its ``build`` span), which no comparison, layout or cache key
    reads.
    """

    name: str
    blocks: Tuple[GPBlock, ...]
    points: Dict[str, torch.Tensor]
    data: Any
    latent_dim: int
    misfits: Tuple[Misfit, ...] = ()
    latent_init: Optional[Callable[[], torch.Tensor]] = None
    trace: Optional[Record] = dataclasses.field(default=None, compare=False, repr=False)

    @property
    def device(self) -> torch.device:
        return next(iter(self.points.values())).device

    @property
    def dtype(self) -> torch.dtype:
        return next(iter(self.points.values())).dtype

    def block(self, name: str) -> GPBlock:
        for b in self.blocks:
            if b.name == name:
                return b
        raise KeyError(f"no GP block named {name!r} in problem {self.name!r}")

    def init_latent(self) -> torch.Tensor:
        if self.latent_init is not None:
            return self.latent_init().to(device=self.device, dtype=self.dtype)
        return torch.zeros(self.latent_dim, dtype=self.dtype, device=self.device)
