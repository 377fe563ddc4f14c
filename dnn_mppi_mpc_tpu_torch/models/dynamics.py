"""Vehicle dynamics ``f(x, u) -> xdot`` on tensors with any leading batch dims.

Counterpart of ``dnn_mppi_mpc_tpu/models/dynamics.py``: the unicycle, the
kinematic bicycle, the four-wheel torque-input model and the dynamic bicycle
with tire slip, and :func:`residual_dynamics`, which adds a learned residual
(``models/learned.py``) to any of them.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Union

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


@dataclasses.dataclass
class FourWheelParams:
    """Four-wheel torque-input model parameters (mass m, inertia I, wheel
    radius r, wheel separation L)."""

    mass: Union[float, torch.Tensor]
    inertia: Union[float, torch.Tensor]
    wheel_radius: Union[float, torch.Tensor]
    wheel_sep: Union[float, torch.Tensor]

    @classmethod
    def default(cls) -> "FourWheelParams":
        """m = 2.0, I = 2.0296, r = 0.17775, L = 0.5708, the JAX package's
        defaults."""
        return cls(mass=2.0, inertia=2.0296, wheel_radius=0.17775, wheel_sep=0.5708)


def four_wheel_torque(
    x: torch.Tensor, u: torch.Tensor, params: Optional[FourWheelParams] = None
) -> torch.Tensor:
    """Four-wheel model with wheel torques as inputs: state (x, y, θ, v, ω),
    control (τ_fr, τ_fl, τ_rr, τ_rl); v̇ = r/(4m)·Στ,
    ω̇ = r/(L·I)·((τ_fr + τ_rr) − (τ_fl + τ_rl))/2."""
    if params is None:
        params = FourWheelParams.default()
    theta, v, omega = x[..., 2], x[..., 3], x[..., 4]
    t_fr, t_fl, t_rr, t_rl = u[..., 0], u[..., 1], u[..., 2], u[..., 3]
    r, m = params.wheel_radius, params.mass
    L, inertia = params.wheel_sep, params.inertia
    dv = (r / (4.0 * m)) * (t_fr + t_fl + t_rr + t_rl)
    domega = (r / (L * inertia)) * ((t_fr + t_rr) - (t_fl + t_rl)) / 2.0
    return torch.stack(
        [v * torch.cos(theta), v * torch.sin(theta), omega, dv, domega], dim=-1
    )


@dataclasses.dataclass
class DynamicBicycleParams:
    """Dynamic single-track model parameters: mass, yaw inertia, front and
    rear cornering stiffness, and the distances lf, lr of the axles from the
    centre of mass."""

    mass: Union[float, torch.Tensor]
    inertia_z: Union[float, torch.Tensor]
    cornering_front: Union[float, torch.Tensor]
    cornering_rear: Union[float, torch.Tensor]
    lf: Union[float, torch.Tensor]
    lr: Union[float, torch.Tensor]

    @classmethod
    def default(cls) -> "DynamicBicycleParams":
        """m = 4.0, Iz = 0.05865, Cf = Cr = 1000, lf = lr = 0.325 / 2, the
        JAX package's defaults."""
        return cls(mass=4.0, inertia_z=0.05865, cornering_front=1000.0,
                   cornering_rear=1000.0, lf=0.325 / 2, lr=0.325 / 2)


def dynamic_bicycle(
    x: torch.Tensor, u: torch.Tensor, params: Optional[DynamicBicycleParams] = None
) -> torch.Tensor:
    """Dynamic bicycle with sideslip β and lateral tire forces: state
    (x, y, yaw, v), control (a, δ);
    β = atan(lr/(lf+lr)·tan δ),
    f_y = 2·(Cf·sin(atan((v sin β + lf·yaw)/(v cos β)))·cos δ
             + Cr·sin(atan((v sin β − lr·yaw)/(v cos β)))),
    ẋ = v cos(yaw+β), ẏ = v sin(yaw+β), ψ̇ = v sin β / lr,
    v̇ = (a − f_y sin δ)/m. A |v cos β| below 1e-6 is replaced by 1e-6, so
    the model stays finite at rest."""
    if params is None:
        params = DynamicBicycleParams.default()
    yaw, v = x[..., 2], x[..., 3]
    a, steer = u[..., 0], u[..., 1]
    lf, lr = params.lf, params.lr
    beta = torch.atan(lr / (lf + lr) * torch.tan(steer))
    vx = v * torch.cos(beta)
    vx_safe = torch.where(torch.abs(vx) < 1e-6, torch.full_like(vx, 1e-6), vx)
    fy = 2.0 * (
        params.cornering_front
        * torch.sin(torch.atan((v * torch.sin(beta) + lf * yaw) / vx_safe))
        * torch.cos(steer)
        + params.cornering_rear
        * torch.sin(torch.atan((v * torch.sin(beta) - lr * yaw) / vx_safe))
    )
    return torch.stack(
        [
            v * torch.cos(yaw + beta),
            v * torch.sin(yaw + beta),
            v * torch.sin(beta) / lr,
            (a - fy * torch.sin(steer)) / params.mass,
        ],
        dim=-1,
    )


def residual_dynamics(analytic: Callable[[torch.Tensor, torch.Tensor], torch.Tensor],
                      learned: Callable[[torch.Tensor], torch.Tensor]
                      ) -> Callable[[torch.Tensor, torch.Tensor], torch.Tensor]:
    """Analytic dynamics plus a learned residual: f(x, u) = f_a(x, u) +
    NN(concat(x, u)); ``learned`` receives the concatenated features (e.g.
    ``models.learned.make_residual_fn``)."""

    def f(x: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
        return analytic(x, u) + learned(torch.cat([x, u], dim=-1))

    return f


__all__ = [
    "BicycleParams",
    "DynamicBicycleParams",
    "FourWheelParams",
    "dynamic_bicycle",
    "four_wheel_torque",
    "kinematic_bicycle",
    "residual_dynamics",
    "unicycle",
]
