"""PyTorch/CUDA port of the diff-drive MPPI engine of ``dnn_mppi_mpc_tpu``.

Same module paths as the JAX package. Plain tensor code is PyTorch; the hot
path's kernels are hand-written CUDA for Hopper (``csrc/``), compiled at
their first launch. Every kernel has a plain PyTorch version beside it,
which runs on CPU tensors. This package never imports JAX.
"""

from .config import (
    CostAccumulation,
    MPPIConfig,
    MPPIParams,
    SmoothingFilter,
    Temperature,
    params_from_numpy,
)

__all__ = [
    "CostAccumulation",
    "MPPIConfig",
    "MPPIParams",
    "SmoothingFilter",
    "Temperature",
    "params_from_numpy",
]
