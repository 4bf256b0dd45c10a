from .operators import LinearOp, identity, d, d2, laplacian
from .kernels import SquaredExponential, ad_pair_fn, exp_neg_accurate
from .gram_tile import gram_tile_pair_fn
from .assembly import (
    Observable,
    gram_matrix,
    cross_gram,
    adaptive_nugget_diag,
    regularized_gram,
    observable_sizes,
)

__all__ = [
    "LinearOp",
    "identity",
    "d",
    "d2",
    "laplacian",
    "SquaredExponential",
    "ad_pair_fn",
    "exp_neg_accurate",
    "gram_tile_pair_fn",
    "Observable",
    "gram_matrix",
    "cross_gram",
    "adaptive_nugget_diag",
    "regularized_gram",
    "observable_sizes",
]
