"""Config schema shared by the example scripts.

Counterpart of ``nonlinpdes_gpsolver_tpu/utils/config.py``: one dataclass,
per-problem defaults supplied by each script, real boolean flags. The JAX
package's ``apply_runtime`` (platform and x64 switches set before any
device use) becomes :func:`runtime`, which returns the device and dtype a
script builds its tensors with: ``--device`` (default ``cuda``) and
``--x64/--no-x64`` (f64 or f32 on that device; unset, the device's default).
``--show_figure`` is left out: plotting needs matplotlib.
"""

from __future__ import annotations

import argparse
import dataclasses
from typing import List, Optional, Tuple

import torch

from ..ops.backend import default_dtype, resolve_device
from ..ops.kernels import SquaredExponential


@dataclasses.dataclass
class SolverConfig:
    # kernel
    kernel: str = "gaussian"
    kernel_parameter: List[float] = dataclasses.field(default_factory=lambda: [0.2])
    aniso_convention: str = "lengthscale"  # or "precision" (notebook convention)
    nugget: float = 1e-10
    nugget_type: str = "adaptive"
    # sampling
    sampled_type: str = "random"
    N_domain: int = 900
    N_boundary: int = 124
    seed: int = 0
    # Gauss-Newton
    GNsteps: int = 8
    step_size: float = 1.0
    initial: str = "random"
    method: str = "elimination"  # or "relaxation" (elliptic only)
    pen_lambda: float = 1e-10
    # runtime
    device: str = "cuda"
    # None = the device's default: f32 on the card, f64 on the CPU
    x64: Optional[bool] = None


def add_config_args(parser: argparse.ArgumentParser, defaults: SolverConfig) -> None:
    d = defaults
    parser.add_argument("--kernel", type=str, default=d.kernel,
                        choices=["gaussian", "anisotropic_gaussian"])
    parser.add_argument("--kernel_parameter", type=float, nargs="+",
                        default=d.kernel_parameter)
    parser.add_argument("--aniso_convention", type=str, default=d.aniso_convention,
                        choices=["lengthscale", "precision"])
    parser.add_argument("--nugget", type=float, default=d.nugget)
    parser.add_argument("--nugget_type", type=str, default=d.nugget_type,
                        choices=["adaptive", "identity", "none"])
    parser.add_argument("--sampled_type", type=str, default=d.sampled_type,
                        choices=["random", "grid"])
    parser.add_argument("--N_domain", type=int, default=d.N_domain)
    parser.add_argument("--N_boundary", type=int, default=d.N_boundary)
    parser.add_argument("--seed", type=int, default=d.seed)
    parser.add_argument("--GNsteps", type=int, default=d.GNsteps)
    parser.add_argument("--step_size", type=float, default=d.step_size)
    parser.add_argument("--initial", type=str, default=d.initial,
                        choices=["random", "zero"])
    parser.add_argument("--method", type=str, default=d.method,
                        choices=["elimination", "relaxation"])
    parser.add_argument("--pen_lambda", type=float, default=d.pen_lambda)
    parser.add_argument("--device", type=str, default=d.device)
    parser.add_argument("--x64", action=argparse.BooleanOptionalAction, default=d.x64)


def config_from_args(args: argparse.Namespace) -> SolverConfig:
    fields = {f.name for f in dataclasses.fields(SolverConfig)}
    return SolverConfig(**{k: v for k, v in vars(args).items() if k in fields})


def runtime(cfg: SolverConfig) -> Tuple[torch.device, torch.dtype]:
    """The device and dtype of a run: ``cfg.device``, and f64 or f32 as
    ``cfg.x64`` says (the device's default when it is ``None``)."""
    device = resolve_device(cfg.device)
    if cfg.x64 is None:
        return device, default_dtype(device)
    return device, torch.float64 if cfg.x64 else torch.float32


def build_kernel(cfg: SolverConfig) -> SquaredExponential:
    if cfg.kernel == "gaussian":
        if len(cfg.kernel_parameter) != 1:
            raise ValueError("gaussian kernel takes one parameter (sigma)")
        return SquaredExponential.gaussian(cfg.kernel_parameter[0])
    return SquaredExponential.anisotropic(cfg.kernel_parameter, cfg.aniso_convention)
