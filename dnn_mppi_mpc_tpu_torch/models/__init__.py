from .dynamics import BicycleParams, kinematic_bicycle, unicycle
from .integrators import euler_step, rk4_step

__all__ = ["BicycleParams", "kinematic_bicycle", "unicycle", "euler_step", "rk4_step"]
