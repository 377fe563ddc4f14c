"""The planar scene as an image — counterpart of ``dnn_mppi_mpc_tpu/envs/render.py``,
the camera stand-in for pixel-input RL (``train.rl.PixelActorCritic``).

A top-down world-frame frame of the robot, its goal and the obstacles,
computed as elementwise tensor math on the inputs' device for any leading
batch (the JAX function renders one frame and is ``vmap``ped), so a rollout
renders its fleet's frames without leaving the card. Channels: 0 the robot
body and a heading marker, 1 the goal, 2 the obstacles.
"""

from __future__ import annotations

from typing import Optional

import torch


def _grid(size: int, extent: float, dtype, device) -> torch.Tensor:
    """``jnp.linspace(-extent, extent, size)`` as JAX computes it:
    start·(1 − s) + stop·s at s = i/(size − 1), the last point ``extent``."""
    s = torch.arange(size - 1, dtype=dtype, device=device) / (size - 1)
    lin = -extent * (1 - s) + extent * s
    return torch.cat([lin, torch.full((1,), extent, dtype=dtype, device=device)])


def _blob(xg, yg, cx, cy, radius: float) -> torch.Tensor:
    """A soft disk, exp(−d²/2r²): smooth in the position it marks."""
    d2 = (xg - cx) ** 2 + (yg - cy) ** 2
    return torch.exp(-0.5 * d2 / (radius * radius))


def raster_scene(pose: torch.Tensor, goal: torch.Tensor,
                 obstacles: Optional[torch.Tensor] = None, *, size: int = 48,
                 extent: float = 5.0) -> torch.Tensor:
    """Render (…, size, size, 3) frames in [0, 1], channels last, over the
    square [−extent, extent]²: row i is y = lin[i], column j is x = lin[j].
    ``pose`` (…, 3) x, y, yaw; ``goal`` (…, 2); ``obstacles`` (…, n_obs, 3)
    x, y, r, or None. The leading dims of the three broadcast."""
    lin = _grid(size, extent, pose.dtype, pose.device)
    xg, yg = lin[None, :], lin[:, None]  # meshgrid(indexing="xy")

    def at(v):  # a (…,) coordinate against the (size, size) grid
        return v[..., None, None]

    x, y, yaw = at(pose[..., 0]), at(pose[..., 1]), at(pose[..., 2])
    body = _blob(xg, yg, x, y, 0.35)
    # a smaller blob ahead of the body: the heading, observable in one frame
    hx, hy = x + 0.55 * torch.cos(yaw), y + 0.55 * torch.sin(yaw)
    robot = torch.clamp(body + 0.7 * _blob(xg, yg, hx, hy, 0.18), 0.0, 1.0)
    goal_ch = _blob(xg, yg, at(goal[..., 0]), at(goal[..., 1]), 0.4)

    obs_ch = torch.zeros_like(robot)
    if obstacles is not None:
        for i in range(obstacles.shape[-2]):  # a few obstacles, unrolled as in JAX
            ob = obstacles[..., i, :]
            d = torch.sqrt((xg - at(ob[..., 0])) ** 2 + (yg - at(ob[..., 1])) ** 2)
            obs_ch = torch.maximum(obs_ch, torch.clamp(1.0 - (d - at(ob[..., 2])) / 0.3, 0.0, 1.0))
    robot, goal_ch, obs_ch = torch.broadcast_tensors(robot, goal_ch, obs_ch)
    return torch.stack([robot, goal_ch, obs_ch], dim=-1)


__all__ = ["raster_scene"]
