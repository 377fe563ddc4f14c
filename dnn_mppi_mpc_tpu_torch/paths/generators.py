"""Reference-trajectory generators (counterpart of
``dnn_mppi_mpc_tpu/paths/generators.py``: the straight line and the race
car's circle and lemniscate with a reference speed). Each returns a float32
(P, d) tensor on ``device`` with columns (x, y, yaw[, v])."""

from __future__ import annotations

import math

import numpy as np
import torch


def _gradient(y: np.ndarray) -> np.ndarray:
    """np.gradient for 1-D arrays: central differences, one-sided at the ends."""
    interior = (y[2:] - y[:-2]) / 2.0
    return np.concatenate([y[1:2] - y[0:1], interior, y[-1:] - y[-2:-1]])


def _table(columns, device) -> torch.Tensor:
    """Columns built in float64 numpy, rounded to float32 once."""
    return torch.tensor(np.stack(columns, axis=1), dtype=torch.float32, device=device)


def line(start, end, num_points: int = 100, device="cpu") -> torch.Tensor:
    """Straight-line course with constant heading: (P, 3) rows (x, y, yaw)."""
    x = torch.linspace(float(start[0]), float(end[0]), num_points, device=device)
    y = torch.linspace(float(start[1]), float(end[1]), num_points, device=device)
    yaw = math.atan2(float(end[1]) - float(start[1]), float(end[0]) - float(start[0]))
    return torch.stack([x, y, torch.full_like(x, yaw)], dim=1)


def circle_with_speed(
    radius: float, num_points: int = 100, speed: float = 5.0, device="cpu"
) -> torch.Tensor:
    """Circular course with tangent yaw and constant reference speed:
    (P, 4) rows (x, y, yaw, v)."""
    ang = np.linspace(0.0, 2.0 * np.pi, num_points)
    return _table(
        [radius * np.cos(ang), radius * np.sin(ang), ang + np.pi / 2.0,
         np.full_like(ang, speed)],
        device,
    )


def lemniscate_with_speed(
    radius: float, num_points: int = 100, speed: float = 5.0, device="cpu"
) -> torch.Tensor:
    """Lemniscate over t ∈ [0, 2π] with yaw from the numerical gradient and
    constant reference speed: (P, 4) rows (x, y, yaw, v)."""
    t = np.linspace(0.0, 2.0 * np.pi, num_points)
    denom = 1.0 + np.sin(t) ** 2
    x = radius * np.cos(t) / denom
    y = radius * np.sin(t) * np.cos(t) / denom
    yaw = np.arctan2(_gradient(y), _gradient(x))
    return _table([x, y, yaw, np.full_like(t, speed)], device)


__all__ = ["circle_with_speed", "lemniscate_with_speed", "line"]
