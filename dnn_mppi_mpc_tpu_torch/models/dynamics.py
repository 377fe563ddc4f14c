"""Vehicle dynamics ``f(x, u) -> xdot`` on tensors with any leading batch dims.

Counterpart of ``dnn_mppi_mpc_tpu/models/dynamics.py``: the unicycle and the
kinematic bicycle so far (the dynamic bicycle and the four-wheel model are
still to be ported).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Union

import torch


def unicycle(x: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """Differential-drive kinematics: state (x, y, yaw), control (v, ω)."""
    yaw = x[..., 2]
    v, w = u[..., 0], u[..., 1]
    return torch.stack([v * torch.cos(yaw), v * torch.sin(yaw), w], dim=-1)


@dataclasses.dataclass
class BicycleParams:
    """Kinematic-bicycle wheelbase L (2.5 for the MPPI race car)."""

    wheel_base: Union[float, torch.Tensor]


def kinematic_bicycle(
    x: torch.Tensor, u: torch.Tensor, params: Optional[BicycleParams] = None
) -> torch.Tensor:
    """Kinematic bicycle: state (x, y, yaw, v), control (steer δ, accel a);
    ẋ = v cos ψ, ẏ = v sin ψ, ψ̇ = v tan δ / L, v̇ = a."""
    L = params.wheel_base if params is not None else 2.5
    yaw, v = x[..., 2], x[..., 3]
    steer, accel = u[..., 0], u[..., 1]
    return torch.stack(
        [v * torch.cos(yaw), v * torch.sin(yaw), v * torch.tan(steer) / L, accel], dim=-1
    )


__all__ = ["BicycleParams", "kinematic_bicycle", "unicycle"]
