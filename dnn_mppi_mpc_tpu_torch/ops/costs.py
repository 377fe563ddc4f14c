"""Cost and collision primitives batched over leading dims (counterpart of
``dnn_mppi_mpc_tpu/ops/costs.py``)."""

from __future__ import annotations

from functools import lru_cache

import torch

# Large enough to dominate any tracking cost after the softmax, small enough
# that T·penalty stays far from the float32 maximum.
COLLISION_PENALTY = 1.0e7


def circle_robot_collision(
    xy: torch.Tensor, obstacles: torch.Tensor, robot_radius: float = 0.5
) -> torch.Tensor:
    """1.0 where a circular robot of (effective) ``robot_radius`` overlaps any
    obstacle circle (n, 3) = (ox, oy, r), else 0.0."""
    d2 = ((xy[..., None, :2] - obstacles[:, :2]) ** 2).sum(-1)
    hit = d2 < (obstacles[:, 2] + robot_radius) ** 2
    return hit.any(-1).to(xy.dtype)


# 9-point vehicle outline in the body frame with unit half-extents, scaled
# by (length/2, width/2)·margin; the point order of the JAX package's
# VEHICLE_OUTLINE_X/Y. The one definition of the polygon: the scan path uses
# it below, and the bicycle kernel wrappers pass it to the kernels.
VEHICLE_OUTLINE_X = (-1.0, -1.0, 0.0, 1.0, 1.0, 1.0, 0.0, -1.0, -1.0)
VEHICLE_OUTLINE_Y = (0.0, 1.0, 1.0, 1.0, 0.0, -1.0, -1.0, -1.0, 0.0)


@lru_cache(maxsize=None)
def _outline(dtype, device) -> torch.Tensor:
    """The (2, 9) outline on ``device``, copied there once (a host→device
    copy waits for the card; do not mutate the result)."""
    return torch.tensor((VEHICLE_OUTLINE_X, VEHICLE_OUTLINE_Y), dtype=dtype).to(device)


def vehicle_polygon_collision(
    pose: torch.Tensor,
    obstacles: torch.Tensor,
    vehicle_length: float = 4.0,
    vehicle_width: float = 3.0,
    safety_margin_rate: float = 1.5,
) -> torch.Tensor:
    """1.0 where any of the 9 outline points of the vehicle at ``pose``
    (..., >=3) = (x, y, yaw, ...) lies inside an obstacle circle (n, 3) =
    (ox, oy, r), else 0.0."""
    x, y, yaw = pose[..., 0], pose[..., 1], pose[..., 2]
    outline = _outline(pose.dtype, pose.device)
    bx = outline[0] * (0.5 * vehicle_length * safety_margin_rate)
    by = outline[1] * (0.5 * vehicle_width * safety_margin_rate)
    c, s = torch.cos(yaw)[..., None], torch.sin(yaw)[..., None]
    px = bx * c - by * s + x[..., None]  # (..., 9)
    py = bx * s + by * c + y[..., None]
    dx = px[..., :, None] - obstacles[:, 0]  # (..., 9, n)
    dy = py[..., :, None] - obstacles[:, 1]
    hit = dx * dx + dy * dy < obstacles[:, 2] ** 2
    return hit.flatten(-2).any(-1).to(pose.dtype)


def soft_obstacle_cost(
    xy: torch.Tensor,
    obstacle_xy: torch.Tensor,
    safety_distance: float = 2.0,
    weight: float = 100.0,
) -> torch.Tensor:
    """Exponential soft penalty ``weight · Σ_obs exp(d_safe − d)·[d < d_safe]``."""
    d = torch.sqrt(((xy[..., None, :2] - obstacle_xy[:, :2]) ** 2).sum(-1) + 1e-12)
    per_obs = torch.exp(safety_distance - d) * (d < safety_distance)
    return weight * per_obs.sum(-1)


__all__ = [
    "COLLISION_PENALTY",
    "VEHICLE_OUTLINE_X",
    "VEHICLE_OUTLINE_Y",
    "circle_robot_collision",
    "soft_obstacle_cost",
    "vehicle_polygon_collision",
]
