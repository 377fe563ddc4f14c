"""Multi-card execution on ``torch.distributed`` — counterpart of
``dnn_mppi_mpc_tpu/parallel``: the sample-sharded scan-path step, the
sample-sharded two-phase tick, the sharded MPPI fleet and the sharded NMPC
fleet over the ranks of a process group."""

from .distributed import initialize_distributed
from .sharding import (
    make_sharded_fused_mppi_step,
    make_sharded_mppi_fleet,
    make_sharded_mppi_step,
    make_sharded_nmpc_fleet,
)

__all__ = [
    "initialize_distributed",
    "make_sharded_fused_mppi_step",
    "make_sharded_mppi_fleet",
    "make_sharded_mppi_step",
    "make_sharded_nmpc_fleet",
]
