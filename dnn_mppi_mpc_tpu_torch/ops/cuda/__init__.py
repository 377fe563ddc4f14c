"""Hand-written CUDA kernels of the MPPI hot paths — the diff-drive ticks,
the two phases of the sample-sharded tick, the fleet tick, the race-car
(kinematic bicycle) ticks, the generic tick and rollout over tile-step
dynamics, the NMPC engine's fused barrier-Riccati QP (one problem, or a
fleet in one launch), and the learned residuals' fused MLP and folded
ResNet chain — each beside its plain PyTorch version (counterpart of
``dnn_mppi_mpc_tpu/ops/pallas``).

Importing this package builds nothing: the kernels are compiled at their
first launch (``dnn_mppi_mpc_tpu_torch._build``)."""

from .bicycle_tick import bicycle_mppi_tick, bicycle_mppi_tick_plain
from .dense_chain import make_resnet_chain_fn, resnet_chain, resnet_chain_plain
from .generic_tick import (
    generic_mppi_tick,
    generic_mppi_tick_plain,
    generic_rollout_costs,
    generic_rollout_costs_plain,
)
from .mlp_step import (
    fold_residual_mlp,
    fused_mlp_apply,
    fused_mlp_apply_plain,
    make_fused_residual_step,
)
from .mppi_tick import diffdrive_mppi_tick, diffdrive_mppi_tick_plain
from .mppi_tick_blocked import (
    diffdrive_mppi_tick_blocked,
    diffdrive_mppi_tick_blocked_plain,
    fleet_mppi_tick,
    fleet_mppi_tick_plain,
    weighted_noise_reduce,
    weighted_noise_reduce_plain,
)
from .riccati_qp import (
    batched_fused_barrier_qp_solve,
    batched_fused_barrier_qp_solve_plain,
    fused_barrier_qp_solve,
    fused_barrier_qp_solve_plain,
)
from .rollout import diffdrive_rollout_costs, diffdrive_rollout_costs_plain
from .rollout_bicycle import bicycle_rollout_costs, bicycle_rollout_costs_plain

KERNEL_WRAPPERS = (
    diffdrive_rollout_costs,
    diffdrive_mppi_tick,
    diffdrive_mppi_tick_blocked,
    bicycle_rollout_costs,
    bicycle_mppi_tick,
    fleet_mppi_tick,
    weighted_noise_reduce,
    generic_mppi_tick,
    generic_rollout_costs,
    fused_barrier_qp_solve,
    batched_fused_barrier_qp_solve,
    fused_mlp_apply,
    resnet_chain,
)
PLAIN_VERSIONS = (
    diffdrive_rollout_costs_plain,
    diffdrive_mppi_tick_plain,
    diffdrive_mppi_tick_blocked_plain,
    bicycle_rollout_costs_plain,
    bicycle_mppi_tick_plain,
    fleet_mppi_tick_plain,
    weighted_noise_reduce_plain,
    generic_mppi_tick_plain,
    generic_rollout_costs_plain,
    fused_barrier_qp_solve_plain,
    batched_fused_barrier_qp_solve_plain,
    fused_mlp_apply_plain,
    resnet_chain_plain,
)


def reset_counts() -> None:
    """Zero every wrapper's launch count and every plain version's call count."""
    for fn in KERNEL_WRAPPERS:
        fn.launches = 0
    for fn in PLAIN_VERSIONS:
        fn.calls = 0


__all__ = [
    "KERNEL_WRAPPERS",
    "PLAIN_VERSIONS",
    "batched_fused_barrier_qp_solve",
    "batched_fused_barrier_qp_solve_plain",
    "bicycle_mppi_tick",
    "bicycle_mppi_tick_plain",
    "bicycle_rollout_costs",
    "bicycle_rollout_costs_plain",
    "diffdrive_mppi_tick",
    "diffdrive_mppi_tick_blocked",
    "diffdrive_mppi_tick_blocked_plain",
    "diffdrive_mppi_tick_plain",
    "diffdrive_rollout_costs",
    "diffdrive_rollout_costs_plain",
    "fleet_mppi_tick",
    "fleet_mppi_tick_plain",
    "fold_residual_mlp",
    "fused_barrier_qp_solve",
    "fused_barrier_qp_solve_plain",
    "fused_mlp_apply",
    "fused_mlp_apply_plain",
    "generic_mppi_tick",
    "generic_mppi_tick_plain",
    "generic_rollout_costs",
    "generic_rollout_costs_plain",
    "make_fused_residual_step",
    "make_resnet_chain_fn",
    "reset_counts",
    "resnet_chain",
    "resnet_chain_plain",
    "weighted_noise_reduce",
    "weighted_noise_reduce_plain",
]
