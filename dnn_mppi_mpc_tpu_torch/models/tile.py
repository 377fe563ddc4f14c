"""Tile-form discrete dynamics for the generic MPPI tick.

Counterpart of ``dnn_mppi_mpc_tpu/models/tile.py``. A tile step maps the
per-dimension state and control tensors of all samples to the next state:

    step(xs: tuple[nx tensors], vs: tuple[nu tensors]) -> tuple[nx tensors]

Each factory here is the Euler discretization of the matching model in
``models/dynamics.py`` and returns a :class:`TileStep`: the plain PyTorch
function together with its family and its float32 constants, so that the
generic kernel (``csrc/generic_rollout.cuh``) runs the same step, operation
for operation, as a compiled functor. The kernel knows the four built-in
families; a step from :func:`lift_dynamics` (family None) runs only in the
plain version, on CPU tensors. Only the factories make a step of a family:
the kernel reads the family and the constants, never the function, so a
step that paired a family with another function or other constants would
run one model on the card and another on the CPU.

``sincos="poly"`` (the JAX package's TPU polynomial) is not ported: the
factories take ``"native"`` only, and ``"poly"`` raises.
"""

from __future__ import annotations

import dataclasses
import math
import weakref
from typing import Callable, Optional, Sequence, Tuple

import numpy as np
import torch

from .dynamics import DynamicBicycleParams, FourWheelParams

Tiles = Tuple[torch.Tensor, ...]

# The families the CUDA kernel compiles in, in the order of its `model` field.
FAMILIES = ("unicycle", "kinematic_bicycle", "four_wheel_torque", "dynamic_bicycle")

# fn -> (family, nx, nu, constants, takes_t) of each step a factory made.
_FACTORY_MADE: "weakref.WeakKeyDictionary[Callable, tuple]" = weakref.WeakKeyDictionary()


@dataclasses.dataclass(frozen=True)
class TileStep:
    """A tile step: ``family`` names the kernel functor (None for a lifted
    step, which the kernel cannot run); ``constants`` are the float32 values
    the factory baked in (dt first), in the order the functor reads them;
    ``takes_t`` marks a step called as ``fn(xs, vs, t)``."""

    family: Optional[str]
    nx: Optional[int]
    nu: Optional[int]
    constants: Tuple[float, ...]
    takes_t: bool
    fn: Callable

    def __post_init__(self):
        fields = (self.family, self.nx, self.nu, self.constants, self.takes_t)
        if self.family is not None and _FACTORY_MADE.get(self.fn) != fields:
            raise ValueError(
                f"a TileStep of family {self.family!r} is made only by its factory in "
                "models/tile.py, with the factory's own function and constants: the kernel "
                "runs the family's built-in step whatever fn is. Wrap a step of your own "
                "with lift_dynamics (it runs on CPU tensors only)"
            )

    def __call__(self, xs: Sequence[torch.Tensor], vs: Sequence[torch.Tensor], *t) -> Tiles:
        return tuple(self.fn(tuple(xs), tuple(vs), *t))


def _factory_made(family: str, nx: int, nu: int, constants: Tuple[float, ...],
                  fn: Callable) -> TileStep:
    """The step a factory made, recorded so that :class:`TileStep` accepts
    its family."""
    _FACTORY_MADE[fn] = (family, nx, nu, constants, False)
    return TileStep(family, nx, nu, constants, False, fn)


def _f32(x: float) -> float:
    return float(np.float32(x))


def _native(sincos: str) -> None:
    if sincos != "native":
        raise ValueError(
            f"sincos={sincos!r} is a TPU-only polynomial; the port's tile steps use "
            "the native sin/cos (sincos='native')"
        )


def _div(x: torch.Tensor, c: float) -> torch.Tensor:
    """x / c with a tensor divisor: PyTorch turns division by a Python scalar
    into a multiplication by its reciprocal on the card, which can round
    otherwise than the kernel's division."""
    return x / torch.full_like(x, c)


# Odd minimax polynomial for atan on [-1, 1] (Abramowitz & Stegun 4.4.49,
# |err| <= 2e-8), the JAX package's coefficients, as float32.
_ATAN_C = tuple(_f32(c) for c in (
    0.9999993329,
    -0.3332985605,
    0.1994653599,
    -0.1390853351,
    0.0964200441,
    -0.0559098861,
    0.0218612288,
    -0.0040540580,
))
_HALF_PI = _f32(math.pi / 2)


def atan_tile(x: torch.Tensor) -> torch.Tensor:
    """arctan as the A&S polynomial in the order of ``dmm_atan_poly``
    (csrc/generic_rollout.cuh): range-reduced to |t| <= 1 through
    atan(x) = sign(x)·π/2 − atan(1/x) for |x| > 1."""
    ax = torch.abs(x)
    big = ax > 1.0
    t = torch.where(big, torch.ones_like(ax) / torch.clamp_min(ax, 1e-30), ax)
    t2 = t * t
    p = torch.full_like(t, _ATAN_C[-1])
    for c in _ATAN_C[-2::-1]:
        p = p * t2 + c
    r = t * p
    r = torch.where(big, _HALF_PI - r, r)
    return torch.where(x < 0.0, -r, r)


def unicycle_tile(dt: float, sincos: str = "native") -> TileStep:
    """Euler diff-drive: state (x, y, yaw), control (v, ω); equals
    ``euler_step(unicycle, ·, ·, dt)``."""
    _native(sincos)
    dt = _f32(dt)

    def step(xs, vs):
        x, y, yaw = xs
        v, w = vs
        return x + v * torch.cos(yaw) * dt, y + v * torch.sin(yaw) * dt, yaw + w * dt

    return _factory_made("unicycle", 3, 2, (dt,), step)


def kinematic_bicycle_tile(dt: float, wheel_base: float = 2.5, sincos: str = "native") -> TileStep:
    """Euler kinematic bicycle: state (x, y, yaw, v), control (δ, a); equals
    ``euler_step(kinematic_bicycle, ·, ·, dt)``."""
    _native(sincos)
    dt, inv_L = _f32(dt), _f32(1.0 / float(wheel_base))

    def step(xs, vs):
        x, y, yaw, v = xs
        steer, accel = vs
        return (
            x + v * torch.cos(yaw) * dt,
            y + v * torch.sin(yaw) * dt,
            yaw + v * torch.tan(steer) * inv_L * dt,
            v + accel * dt,
        )

    return _factory_made("kinematic_bicycle", 4, 2, (dt, inv_L), step)


def four_wheel_torque_tile(
    dt: float, params: Optional[FourWheelParams] = None, sincos: str = "native"
) -> TileStep:
    """Euler four-wheel torque model: state (x, y, θ, v, ω), control
    (τ_fr, τ_fl, τ_rr, τ_rl); equals ``euler_step(four_wheel_torque, ·, ·,
    dt)``. cv = r/(4m) and cw = r/(L·I)·0.5 are computed in float64, as the
    JAX factory computes them, then rounded to float32."""
    _native(sincos)
    params = FourWheelParams.default() if params is None else params
    r, m = float(params.wheel_radius), float(params.mass)
    L, inertia = float(params.wheel_sep), float(params.inertia)
    dt, cv, cw = _f32(dt), _f32(r / (4.0 * m)), _f32(r / (L * inertia) * 0.5)

    def step(xs, vs):
        x, y, theta, v, omega = xs
        t_fr, t_fl, t_rr, t_rl = vs
        return (
            x + v * torch.cos(theta) * dt,
            y + v * torch.sin(theta) * dt,
            theta + omega * dt,
            v + cv * (t_fr + t_fl + t_rr + t_rl) * dt,
            omega + cw * ((t_fr + t_rr) - (t_fl + t_rl)) * dt,
        )

    return _factory_made("four_wheel_torque", 5, 4, (dt, cv, cw), step)


def dynamic_bicycle_tile(dt: float, params: Optional[DynamicBicycleParams] = None) -> TileStep:
    """Euler dynamic bicycle with tire slip: state (x, y, yaw, v), control
    (a, δ); equals ``euler_step(dynamic_bicycle, ·, ·, dt)`` up to the atan
    polynomial (:func:`atan_tile`, within ~2e-8 of arctan), with the
    vx ≈ 0 guard."""
    params = DynamicBicycleParams.default() if params is None else params
    lf, lr = float(params.lf), float(params.lr)
    consts = tuple(_f32(c) for c in (
        dt, lr / (lf + lr), lf, lr, float(params.cornering_front),
        float(params.cornering_rear), 1.0 / float(params.mass),
    ))
    dt, beta_gain, lf, lr, cf, cr, inv_m = consts

    def step(xs, vs):
        x, y, yaw, v = xs
        a, steer = vs
        beta = atan_tile(beta_gain * torch.tan(steer))
        vx = v * torch.cos(beta)
        vx_safe = torch.where(torch.abs(vx) < _f32(1e-6), torch.full_like(vx, 1e-6), vx)
        vs_beta = v * torch.sin(beta)
        fy = 2.0 * (
            cf * torch.sin(atan_tile((vs_beta + lf * yaw) / vx_safe)) * torch.cos(steer)
            + cr * torch.sin(atan_tile((vs_beta - lr * yaw) / vx_safe))
        )
        return (
            x + v * torch.cos(yaw + beta) * dt,
            y + v * torch.sin(yaw + beta) * dt,
            yaw + _div(vs_beta, lr) * dt,
            v + (a - fy * torch.sin(steer)) * inv_m * dt,
        )

    return _factory_made("dynamic_bicycle", 4, 2, consts, step)


def lift_dynamics(dynamics_step: Callable[[torch.Tensor, torch.Tensor], torch.Tensor]) -> TileStep:
    """Adapt an ``(..., nx)``-style discrete step F(x, u) to tile form: stack
    the tiles on the last axis, call F once, unstack. Family None: the
    kernel refuses it on the card (write a tile step of a built-in family
    there); on CPU tensors the plain version runs it."""

    def step(xs, vs):
        y = dynamics_step(torch.stack(xs, dim=-1), torch.stack(vs, dim=-1))
        return tuple(y[..., i] for i in range(len(xs)))

    return TileStep(None, None, None, (), False, step)


def lift_dynamics_time_varying(
    dynamics_step: Callable[[torch.Tensor, torch.Tensor, int], torch.Tensor],
) -> TileStep:
    """:func:`lift_dynamics` for a step-indexed F(x, u, t), ``t`` the rollout
    step; pair with ``MPPIConfig.time_varying_dynamics=True``."""

    def step(xs, vs, t):
        y = dynamics_step(torch.stack(xs, dim=-1), torch.stack(vs, dim=-1), t)
        return tuple(y[..., i] for i in range(len(xs)))

    return TileStep(None, None, None, (), True, step)


__all__ = [
    "FAMILIES",
    "TileStep",
    "atan_tile",
    "dynamic_bicycle_tile",
    "four_wheel_torque_tile",
    "kinematic_bicycle_tile",
    "lift_dynamics",
    "lift_dynamics_time_varying",
    "unicycle_tile",
]
