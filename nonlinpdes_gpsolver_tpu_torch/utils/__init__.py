# tracing first: ops/ and solvers/ import it while this package is still importing
from . import tracing
from . import classical, config
from .sampling import sample_random, sample_grid, test_grid
from .metrics import ErrorStats, error_stats
from .checkpoint import (
    save_solver_state,
    load_solver_state,
    save_distributed_state,
    load_distributed_state,
)
from .profiling import flop_model, tflops

__all__ = [
    "classical",
    "tracing",
    "config",
    "sample_random",
    "sample_grid",
    "test_grid",
    "ErrorStats",
    "error_stats",
    "save_solver_state",
    "save_distributed_state",
    "load_distributed_state",
    "load_solver_state",
    "flop_model",
    "tflops",
]
