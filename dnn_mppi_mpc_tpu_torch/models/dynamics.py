"""Vehicle dynamics ``f(x, u) -> xdot`` on tensors with any leading batch dims.

Counterpart of ``dnn_mppi_mpc_tpu/models/dynamics.py``; the unicycle only so
far (the bicycles and the four-wheel model are still to be ported).
"""

from __future__ import annotations

import torch


def unicycle(x: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """Differential-drive kinematics: state (x, y, yaw), control (v, ω)."""
    yaw = x[..., 2]
    v, w = u[..., 0], u[..., 1]
    return torch.stack([v * torch.cos(yaw), v * torch.sin(yaw), w], dim=-1)


__all__ = ["unicycle"]
