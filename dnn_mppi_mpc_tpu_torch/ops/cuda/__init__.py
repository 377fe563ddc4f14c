"""Hand-written CUDA kernels of the MPPI hot paths — the diff-drive ticks and
the race-car (kinematic bicycle) ticks — each beside its plain PyTorch
version (counterpart of ``dnn_mppi_mpc_tpu/ops/pallas``).

Importing this package builds nothing: the kernels are compiled at their
first launch (``dnn_mppi_mpc_tpu_torch._build``)."""

from .bicycle_tick import bicycle_mppi_tick, bicycle_mppi_tick_plain
from .mppi_tick import diffdrive_mppi_tick, diffdrive_mppi_tick_plain
from .mppi_tick_blocked import diffdrive_mppi_tick_blocked, diffdrive_mppi_tick_blocked_plain
from .rollout import diffdrive_rollout_costs, diffdrive_rollout_costs_plain
from .rollout_bicycle import bicycle_rollout_costs, bicycle_rollout_costs_plain

KERNEL_WRAPPERS = (
    diffdrive_rollout_costs,
    diffdrive_mppi_tick,
    diffdrive_mppi_tick_blocked,
    bicycle_rollout_costs,
    bicycle_mppi_tick,
)
PLAIN_VERSIONS = (
    diffdrive_rollout_costs_plain,
    diffdrive_mppi_tick_plain,
    diffdrive_mppi_tick_blocked_plain,
    bicycle_rollout_costs_plain,
    bicycle_mppi_tick_plain,
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
    "reset_counts",
]
