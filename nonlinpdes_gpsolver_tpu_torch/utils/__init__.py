from . import classical, config
from .sampling import sample_random, sample_grid, test_grid
from .metrics import ErrorStats, PhaseTimers, error_stats

__all__ = [
    "classical",
    "config",
    "sample_random",
    "sample_grid",
    "test_grid",
    "ErrorStats",
    "PhaseTimers",
    "error_stats",
]
