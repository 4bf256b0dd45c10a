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

import contextlib

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


_card_numerics_on_cpu = False


@contextlib.contextmanager
def card_numerics_on_cpu():
    """Within the block, CPU tensors take the card's numerics
    (:func:`is_accelerator` is true for them): f32 by default,
    ``solve_mode='inverse'`` with the Newton step, the controlled SPD solve.
    It rehearses a card run on the CPU (``scripts/torch_cpu_rehearsal.py``);
    the Gram kernel's plain version still stands in for the kernel."""
    global _card_numerics_on_cpu
    prev, _card_numerics_on_cpu = _card_numerics_on_cpu, True
    try:
        yield
    finally:
        _card_numerics_on_cpu = prev


def is_accelerator(device) -> bool:
    """True for a CUDA device (f32 working precision, guarded linear algebra),
    and for the CPU inside :func:`card_numerics_on_cpu`."""
    kind = torch.device(device).type
    return kind == "cuda" or (kind == "cpu" and _card_numerics_on_cpu)


def default_dtype(device) -> torch.dtype:
    """f32 on the card, f64 on the CPU (``ops/backend.py`` rule of the JAX package)."""
    return torch.float32 if is_accelerator(device) else torch.float64
