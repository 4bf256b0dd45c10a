"""Error metrics.

Counterpart of ``nonlinpdes_gpsolver_tpu/utils/metrics.py``. The error
reduction runs on the tensors' device and only two scalars reach the host.
The solver's phase timers are ``utils/tracing.py``'s.
"""

from __future__ import annotations

import dataclasses

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
