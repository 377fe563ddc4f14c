"""Actuator-level inverse kinematics: wheel commands from body commands
(counterpart of ``dnn_mppi_mpc_tpu/envs/kinematics.py``).

* diff-drive / skid-steer wheel speeds (the reference's
  simulation/bullet_differential_drive_dnn.py:20-34, Husky wheel
  separation L = 0.5708);
* Ackermann drive and steer wheel speeds
  (controllers/bullet_mpc_race_car_obstacle.py:384-394).

Batched over leading dims, on whatever device the inputs lie on.
"""

from __future__ import annotations

import torch

HUSKY_WHEEL_SEP = 0.5708


def diff_drive_wheel_speeds(
    v: torch.Tensor, omega: torch.Tensor, wheel_sep: float = HUSKY_WHEEL_SEP
) -> torch.Tensor:
    """(..., 4) wheel speeds (front-left, front-right, rear-left, rear-right)
    from body speed v and yaw rate ω."""
    v_left = v - omega * wheel_sep / 2.0
    v_right = v + omega * wheel_sep / 2.0
    return torch.stack([v_left, v_right, v_left, v_right], dim=-1)


def ackermann_wheel_speeds(
    v: torch.Tensor, steer: torch.Tensor, wheel_base: float, track_width: float
) -> torch.Tensor:
    """(..., 4) wheel speeds (left-rear, right-rear, left-front, right-front)
    of an Ackermann car."""
    t = torch.tan(steer)
    v_lrw = v * (1.0 - track_width * t / (2.0 * wheel_base))
    v_rrw = v * (1.0 + track_width * t / (2.0 * wheel_base))
    v_lfw = torch.sqrt(v**2 + ((v * t / 2.0) - (v * track_width * t / (2.0 * wheel_base))) ** 2)
    v_rfw = torch.sqrt(v**2 + ((v * t / 2.0) + (v * track_width * t / (2.0 * wheel_base))) ** 2)
    return torch.stack([v_lrw, v_rrw, v_lfw, v_rfw], dim=-1)


__all__ = ["diff_drive_wheel_speeds", "ackermann_wheel_speeds", "HUSKY_WHEEL_SEP"]
