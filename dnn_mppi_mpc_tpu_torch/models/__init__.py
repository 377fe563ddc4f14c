from .dynamics import (
    BicycleParams,
    DynamicBicycleParams,
    FourWheelParams,
    dynamic_bicycle,
    four_wheel_torque,
    kinematic_bicycle,
    unicycle,
)
from .integrators import euler_step, rk4_step
from .tile import (
    FAMILIES,
    TileStep,
    atan_tile,
    dynamic_bicycle_tile,
    four_wheel_torque_tile,
    kinematic_bicycle_tile,
    lift_dynamics,
    lift_dynamics_time_varying,
    unicycle_tile,
)

__all__ = [
    "BicycleParams",
    "DynamicBicycleParams",
    "FAMILIES",
    "FourWheelParams",
    "TileStep",
    "atan_tile",
    "dynamic_bicycle",
    "dynamic_bicycle_tile",
    "euler_step",
    "four_wheel_torque",
    "four_wheel_torque_tile",
    "kinematic_bicycle",
    "kinematic_bicycle_tile",
    "lift_dynamics",
    "lift_dynamics_time_varying",
    "rk4_step",
    "unicycle",
    "unicycle_tile",
]
