"""Cost and collision primitives batched over leading dims (counterpart of
``dnn_mppi_mpc_tpu/ops/costs.py``; the vehicle-polygon cost is still to be
ported)."""

from __future__ import annotations

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


__all__ = ["COLLISION_PENALTY", "circle_robot_collision", "soft_obstacle_cost"]
