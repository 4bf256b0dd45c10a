from . import comm
from .mesh import Mesh, make_mesh, device_count, initialize_distributed
from .cholesky import (
    BlockCyclicFactor,
    cholesky_blockcyclic,
    trsm_blockcyclic,
    kernel_solve_blockcyclic,
    matvec_blockcyclic,
    pad_to_blocks,
    shard_rows_blockcyclic,
    unshard_rows_blockcyclic,
)
from .gram import assemble_gram_sharded
from .fused import assemble_factor_fused, sampled_row_quality

__all__ = [
    "Mesh",
    "make_mesh",
    "device_count",
    "initialize_distributed",
    "comm",
    "BlockCyclicFactor",
    "cholesky_blockcyclic",
    "trsm_blockcyclic",
    "kernel_solve_blockcyclic",
    "matvec_blockcyclic",
    "pad_to_blocks",
    "shard_rows_blockcyclic",
    "unshard_rows_blockcyclic",
    "assemble_gram_sharded",
    "assemble_factor_fused",
    "sampled_row_quality",
]
