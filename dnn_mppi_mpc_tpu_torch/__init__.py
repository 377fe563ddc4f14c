"""PyTorch/CUDA port of the MPPI and NMPC engines of ``dnn_mppi_mpc_tpu``.

Same module paths as the JAX package. Plain tensor code is PyTorch; the hot
path's kernels are hand-written CUDA for Hopper (``csrc/``), compiled at
their first launch. Every kernel has a plain PyTorch version beside it,
which runs on CPU tensors. This package never imports JAX. The command
line is ``python -m dnn_mppi_mpc_tpu_torch <command>`` (``cli.py``).
"""

__version__ = "0.1.0"  # the JAX package's

from .config import (
    CostAccumulation,
    MPPIConfig,
    MPPIParams,
    SmoothingFilter,
    SQPConfig,
    Temperature,
    params_from_numpy,
)

__all__ = [
    "__version__",
    "CostAccumulation",
    "MPPIConfig",
    "MPPIParams",
    "SmoothingFilter",
    "SQPConfig",
    "Temperature",
    "params_from_numpy",
]
