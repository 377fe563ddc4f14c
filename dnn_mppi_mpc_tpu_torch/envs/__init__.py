"""Closed loops, plants, obstacles, sensors and the scene rasterizer
(counterpart of ``dnn_mppi_mpc_tpu/envs``; its PyBullet bridge is not
ported)."""

from .closed_loop import Episode, collect_residual_dataset, run_closed_loop
from .kinematics import ackermann_wheel_speeds, diff_drive_wheel_speeds
from .obstacles import chase_obstacles, drift_obstacles, sinusoid_obstacles
from .plants import Plant, PlantState
from .render import raster_scene

__all__ = [
    "Episode",
    "Plant",
    "PlantState",
    "ackermann_wheel_speeds",
    "chase_obstacles",
    "collect_residual_dataset",
    "diff_drive_wheel_speeds",
    "drift_obstacles",
    "raster_scene",
    "run_closed_loop",
    "sinusoid_obstacles",
]
