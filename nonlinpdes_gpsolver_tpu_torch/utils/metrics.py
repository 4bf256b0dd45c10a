"""Error metrics and phase timers.

Counterpart of ``nonlinpdes_gpsolver_tpu/utils/metrics.py``. The error
reduction runs on the tensors' device and only two scalars reach the host.
Phase timers synchronize a CUDA device at the end of each phase, so a
phase's seconds include the device work it queued.
"""

from __future__ import annotations

import dataclasses
import time
from contextlib import contextmanager
from typing import Dict

import torch


@dataclasses.dataclass(frozen=True)
class ErrorStats:
    max: float
    l2: float  # RMS: sqrt(mean(err^2)) - the reference's "L2 error"

    def __repr__(self):
        return f"ErrorStats(max={self.max:.4e}, l2={self.l2:.4e})"


def error_stats(pred: torch.Tensor, truth: torch.Tensor) -> ErrorStats:
    """Max / RMS error, reduced where the tensors lie; one two-scalar fetch."""
    e = torch.abs(pred - truth.to(device=pred.device, dtype=pred.dtype))
    mx, l2 = torch.stack([e.max(), torch.sqrt(torch.mean(e * e))]).tolist()
    return ErrorStats(max=mx, l2=l2)


class PhaseTimers:
    """Named wall-clock accumulators (assembly / factorization / GN / ...).

    With a CUDA ``device`` each phase ends with a synchronize of that device.
    """

    def __init__(self, device=None):
        self.seconds: Dict[str, float] = {}
        self._cuda = device is not None and torch.device(device).type == "cuda"
        self._device = device

    @contextmanager
    def phase(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if self._cuda:
                torch.cuda.synchronize(self._device)
            self.seconds[name] = self.seconds.get(name, 0.0) + (
                time.perf_counter() - t0
            )

    def as_dict(self) -> Dict[str, float]:
        return dict(self.seconds)
