"""Exteroceptive sensor models (counterpart of
``dnn_mppi_mpc_tpu/envs/sensors.py``), batched over leading dims.

* 2-D lidar against circular obstacles: the reference's PyBullet
  ``rayTestBatch`` sweep (test/test_husky.py:45-69) as a closed-form
  ray/circle intersection over beams × obstacles;
* goal-relative observation features for goal-seeking policies.
"""

from __future__ import annotations

import math

import torch


def lidar_scan(
    pose: torch.Tensor,
    obstacles: torch.Tensor,
    num_beams: int = 36,
    max_range: float = 10.0,
    fov: float = 2.0 * math.pi,
) -> torch.Tensor:
    """Range per beam from pose (x, y, yaw) against circle obstacles (n, 3).

    Beams span ``fov`` centred on the heading. A full circle leaves out the
    duplicate endpoint (−π and +π are one direction): its B beams are
    −π + 2π·i/B. A ray p + t·d meets a circle |q + t·d|² = r² (q = p − c) at
    t = −q·d − sqrt((q·d)² − |q|² + r²); the smallest positive root wins,
    else ``max_range`` (PyBullet's miss, fraction 1)."""
    x, y, yaw = pose[..., 0], pose[..., 1], pose[..., 2]
    full_circle = abs(float(fov) - 2.0 * math.pi) < 1e-6
    # np.linspace(-fov/2, fov/2, B, endpoint=not full_circle), written out
    # (torch.linspace has no endpoint argument), in float64 then rounded
    steps = num_beams if full_circle else max(num_beams - 1, 1)
    offsets = torch.arange(num_beams, dtype=torch.float64, device=pose.device)
    offsets = offsets * (fov / steps) - fov / 2.0
    angles = yaw[..., None] + offsets.to(pose.dtype)
    dx, dy = torch.cos(angles), torch.sin(angles)  # (..., B)

    qx = x[..., None, None] - obstacles[..., :, 0]  # (..., 1, n_obs)
    qy = y[..., None, None] - obstacles[..., :, 1]
    r = obstacles[..., :, 2]
    b = dx[..., :, None] * qx + dy[..., :, None] * qy  # (..., B, n_obs)
    c0 = qx * qx + qy * qy - r * r
    disc = b * b - c0
    t = -b - torch.sqrt(torch.clamp(disc, min=0.0))
    t = torch.where((disc >= 0.0) & (t > 0.0), t, torch.inf)
    return torch.clamp(t.amin(-1), max=max_range)


def goal_relative_obs(pose: torch.Tensor, goal: torch.Tensor) -> torch.Tensor:
    """(distance, bearing, heading error) features for goal-seeking policies."""
    d = goal[..., :2] - pose[..., :2]
    dist = torch.linalg.vector_norm(d, dim=-1)
    bearing = torch.atan2(d[..., 1], d[..., 0]) - pose[..., 2]
    bearing = torch.atan2(torch.sin(bearing), torch.cos(bearing))
    if goal.shape[-1] > 2:
        err = goal[..., 2] - pose[..., 2]
        heading_err = torch.atan2(torch.sin(err), torch.cos(err))
    else:
        heading_err = torch.zeros_like(dist)
    return torch.stack([dist, bearing, heading_err], dim=-1)


__all__ = ["lidar_scan", "goal_relative_obs"]
