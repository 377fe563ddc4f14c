from .mppi import (
    CostContext,
    MPPIAux,
    MPPISolver,
    MPPIState,
    make_cuda_bicycle_rollout,
    make_cuda_bicycle_tick,
    make_cuda_diffdrive_rollout,
    make_cuda_diffdrive_tick,
    make_cuda_diffdrive_tick_blocked,
    make_tracking_costs,
    mppi_step,
    state_from_numpy,
)

__all__ = [
    "CostContext",
    "MPPIAux",
    "MPPISolver",
    "MPPIState",
    "make_cuda_bicycle_rollout",
    "make_cuda_bicycle_tick",
    "make_cuda_diffdrive_rollout",
    "make_cuda_diffdrive_tick",
    "make_cuda_diffdrive_tick_blocked",
    "make_tracking_costs",
    "mppi_step",
    "state_from_numpy",
]
