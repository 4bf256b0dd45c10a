"""PyTorch/CUDA port of the GP solver for nonlinear PDEs.

A second package beside the JAX package ``nonlinpdes_gpsolver_tpu``, which
stays the reference. It keeps that package's layout (``ops/``, ``models/``,
``solvers/``, ``utils/``, ``api.py``) and imports nothing from it or from
JAX. Entry points run on the CUDA card unless given ``device="cpu"``; the
working dtype is f32 on the card and f64 on the CPU. The derivative-kernel
Gram blocks go through a CUDA C++ kernel for ``sm_90a``
(``csrc/gram_tile.cu``), built at first use. Past 16,384 Gram rows (or
with ``GPSolver(..., mesh=parallel.make_mesh(P))``) the solve takes the
JAX package's mesh path (``parallel/``, ``solvers/distributed.py``), on one
device or across P ranks of ``torch.distributed``.

Importing the package turns TF32 off for float32 matmuls and convolutions:
the factorizations and whitening need full f32 products, the hazard that
``Precision.HIGHEST`` guards against in the JAX package.
"""

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
torch.set_float32_matmul_precision("highest")

# utils first: its tracing module is imported by ops/ and solvers/, which
# utils' checkpoint module imports in turn
from . import utils  # noqa: E402
from . import compat, interop, models, ops, parallel, solvers, workloads  # noqa: E402
from .api import GPSolver, SolveResult  # noqa: E402
from .ops import SquaredExponential  # noqa: E402
from .solvers import Posterior, clear_graph_cache, factorize, gn_solve  # noqa: E402

__all__ = [
    "GPSolver",
    "SolveResult",
    "SquaredExponential",
    "Posterior",
    "clear_graph_cache",
    "factorize",
    "gn_solve",
    "compat",
    "interop",
    "models",
    "ops",
    "parallel",
    "solvers",
    "utils",
    "workloads",
]
