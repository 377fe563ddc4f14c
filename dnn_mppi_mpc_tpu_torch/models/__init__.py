from .dynamics import unicycle
from .integrators import euler_step, rk4_step

__all__ = ["unicycle", "euler_step", "rk4_step"]
