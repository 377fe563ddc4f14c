"""Moving-obstacle models for dynamic scenarios (counterpart of
``dnn_mppi_mpc_tpu/envs/obstacles.py``): the reference's three motion
patterns.

* constant-velocity drift (test/test_mppi_diff_obs.py:14-20: positions =
  initial + velocity·t);
* goal-chasing cubes (simulation/bullet_differential_drive_dnn.py:398-408:
  a step toward a chase target each tick);
* scripted sinusoids (controllers/mpc_differential_dynamics.py:296-315).

Each returns new positions and leaves its inputs as they were; extra
columns (radii) pass through. ``t`` may be a Python number or a tensor on
the obstacles' device.
"""

from __future__ import annotations

import torch


def _with_xy(positions: torch.Tensor, xy: torch.Tensor) -> torch.Tensor:
    """``positions`` with its first two columns replaced by ``xy``."""
    return torch.cat([xy, positions[..., 2:]], dim=-1)


def drift_obstacles(initial: torch.Tensor, velocities: torch.Tensor, t) -> torch.Tensor:
    """Constant-velocity obstacles: (n, 2|3) positions at time t."""
    return _with_xy(initial, initial[..., :2] + velocities[..., :2] * t)


def chase_obstacles(positions: torch.Tensor, target: torch.Tensor, speed: float,
                    dt: float) -> torch.Tensor:
    """Advance obstacles one step of ``speed · dt`` toward a chase target."""
    d = target[..., :2] - positions[..., :2]
    norm = torch.linalg.vector_norm(d, dim=-1, keepdim=True)
    step = torch.where(norm > 1e-6, d / torch.clamp(norm, min=1e-6), 0.0) * speed * dt
    return _with_xy(positions, positions[..., :2] + step)


def sinusoid_obstacles(centers: torch.Tensor, amplitudes, omegas, t) -> torch.Tensor:
    """Scripted oscillating obstacles: centers + amplitude · sin(ω t).

    ``amplitudes`` and ``omegas`` are per-axis ``(n, 2)`` or per-obstacle
    ``(n,)``; a bare ``(n,)`` applies to both axes of its own obstacle,
    never across x and y."""
    amplitudes = torch.as_tensor(amplitudes, dtype=centers.dtype, device=centers.device)
    omegas = torch.as_tensor(omegas, dtype=centers.dtype, device=centers.device)
    if amplitudes.dim() == centers.dim() - 1:
        amplitudes = amplitudes[..., None]
    if omegas.dim() == centers.dim() - 1:
        omegas = omegas[..., None]
    offs = (amplitudes * torch.sin(omegas * t)).expand(centers[..., :2].shape)
    return _with_xy(centers, centers[..., :2] + offs)


__all__ = ["drift_obstacles", "chase_obstacles", "sinusoid_obstacles"]
