"""Device and dtype rules shared by every entry point of the port.

Counterpart of ``nonlinpdes_gpsolver_tpu/ops/backend.py``. The JAX package
asks the default backend; here every tensor carries its device, so the rules
are functions of a ``torch.device``:

* an entry point runs on the CUDA card unless the caller passes
  ``device="cpu"``; with no device given and no card present it raises, and
  it never moves to the CPU on its own (:func:`resolve_device`);
* *accelerator* means ``cuda``: f32 and precision-controlled linear algebra
  there, f64 on the CPU, as in the JAX package (:func:`default_dtype`).
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``device`` if given, else CUDA."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on the CPU"
        )
    return torch.device("cuda")


def is_accelerator(device) -> bool:
    """True for a CUDA device (f32 working precision, guarded linear algebra)."""
    return torch.device(device).type == "cuda"


def default_dtype(device) -> torch.dtype:
    """f32 on the card, f64 on the CPU (``ops/backend.py`` rule of the JAX package)."""
    return torch.float32 if is_accelerator(device) else torch.float64
