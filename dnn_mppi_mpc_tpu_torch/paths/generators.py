"""Reference-trajectory generators (counterpart of
``dnn_mppi_mpc_tpu/paths/generators.py``; only the straight line so far)."""

from __future__ import annotations

import math

import torch


def line(start, end, num_points: int = 100, device="cpu") -> torch.Tensor:
    """Straight-line course with constant heading: (P, 3) rows (x, y, yaw)."""
    x = torch.linspace(float(start[0]), float(end[0]), num_points, device=device)
    y = torch.linspace(float(start[1]), float(end[1]), num_points, device=device)
    yaw = math.atan2(float(end[1]) - float(start[1]), float(end[0]) - float(start[0]))
    return torch.stack([x, y, torch.full_like(x, yaw)], dim=1)


__all__ = ["line"]
