"""Tile-form discrete dynamics for the generic MPPI tick.

Counterpart of ``dnn_mppi_mpc_tpu/models/tile.py``. A tile step maps the
per-dimension state and control tensors of all samples to the next state:

    step(xs: tuple[nx tensors], vs: tuple[nu tensors]) -> tuple[nx tensors]

Each factory here is the Euler discretization of the matching model in
``models/dynamics.py`` and returns a :class:`TileStep`: the plain PyTorch
function together with its family and its float32 constants, so that the
generic kernel (``csrc/generic_rollout.cuh``) runs the same step, operation
for operation, as a hand-written functor. Any other step — one from
:func:`lift_dynamics` or :func:`lift_dynamics_time_varying` (family None) —
runs on the card too: ``ops/cuda/user_tile.py`` traces it into a generated
functor of the same kernels. Only the factories make a step of a family:
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

from ..config import resolve_device
from .dynamics import DynamicBicycleParams, FourWheelParams

Tiles = Tuple[torch.Tensor, ...]

# The families the CUDA kernel compiles in, in the order of its `model` field.
FAMILIES = ("unicycle", "kinematic_bicycle", "four_wheel_torque", "dynamic_bicycle")

# fn -> (family, nx, nu, constants, takes_t) of each step a factory made.
_FACTORY_MADE: "weakref.WeakKeyDictionary[Callable, tuple]" = weakref.WeakKeyDictionary()


@dataclasses.dataclass(frozen=True)
class TileStep:
    """A tile step: ``family`` names the hand-written kernel functor (None
    for any other step, which the kernel runs as a functor generated from a
    trace of ``fn``); ``constants`` are the float32 values the factory baked
    in (dt first), in the order the functor reads them; ``takes_t`` marks a
    step called as ``fn(xs, vs, t)``, t the 0-d int32 rollout step."""

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
                "with lift_dynamics (the card runs it as a generated functor)"
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
    the tiles on the last axis, call F once, unstack. Family None: on the
    card the generic kernels run it as a functor that
    ``ops/cuda/user_tile.py`` generates from a trace of F (built at its first
    launch), on CPU tensors the plain version runs F itself.

    F may use elementwise add, sub, mul, div, neg, pow by a number, sin,
    cos, tan, atan, atan2, exp, log, sqrt, tanh, sigmoid, relu, abs, floor,
    minimum, maximum, clamp, comparisons, logical ops, where, full_like /
    zeros_like / ones_like, Python numbers and captured scalar tensors, and
    select, slice, stack, cat, unsqueeze, expand and unbind on the last axis —
    what ``models/dynamics.py`` with ``euler_step`` or ``rk4_step`` writes —,
    and matrix products of a (K, n) block by captured float32 weights
    (``x @ A.T``, ``torch.nn.functional.linear``, ``addmm``, ``nn.Linear``: a
    linear model or a learned residual, :func:`lift_linear`,
    :func:`lift_mlp_residual`), summed in k order, up to
    ``user_tile.MAX_WEIGHTS`` (16 384) weight values. The card route copies
    the captured weights into one device buffer at the step's first launch,
    and again at a launch after one changed in place (its version counter or
    storage moved, as an optimizer step or ``load_state_dict`` moves them; a
    write through ``.data`` is not seen). A step past that limit, a linear solve
    (``irk_step``), a reduction, or Python control flow on a tensor's value
    raises ``ValueError`` on the card, naming the op or the count."""

    def step(xs, vs):
        y = dynamics_step(torch.stack(xs, dim=-1), torch.stack(vs, dim=-1))
        return tuple(y[..., i] for i in range(len(xs)))

    return TileStep(None, None, None, (), False, step)


def lift_dynamics_time_varying(
    dynamics_step: Callable[[torch.Tensor, torch.Tensor, int], torch.Tensor],
) -> TileStep:
    """:func:`lift_dynamics` for a step-indexed F(x, u, t), ``t`` the rollout
    step as a 0-d int32 tensor (JAX's int32 index; cast it, ``t.to(x.dtype)``,
    where F computes with it); pair with
    ``MPPIConfig.time_varying_dynamics=True``. On the card the generated
    functor takes the kernel's int step; F may use the ops of
    :func:`lift_dynamics` and integer arithmetic and casts of t."""

    def step(xs, vs, t):
        y = dynamics_step(torch.stack(xs, dim=-1), torch.stack(vs, dim=-1), t)
        return tuple(y[..., i] for i in range(len(xs)))

    return TileStep(None, None, None, (), True, step)


def _weights(a, device) -> torch.Tensor:
    return torch.as_tensor(np.ascontiguousarray(a, np.float32), device=device)


def lift_linear(A, B, dt: float, *, device="cuda") -> TileStep:
    """:func:`lift_dynamics` of the linear step x' = x + (x Aᵀ + u Bᵀ)·dt,
    from ``A`` (nx, nx) and ``B`` (nx, nu) given as numpy arrays (the
    JAX package's random-linear step, tests/test_generic_tick.py:420-422),
    kept as float32 tensors on ``device`` (default the card): on the card
    the generated functor reads them from its weight buffer."""
    A_, B_ = _weights(A, resolve_device(device)), _weights(B, resolve_device(device))

    def step(x, u):
        return x + (x @ A_.T + u @ B_.T) * dt

    return lift_dynamics(step)


def lift_mlp_residual(nominal: Callable, layers: Sequence, *, activation: str = "tanh",
                      device="cuda") -> TileStep:
    """:func:`lift_dynamics` of x' = F₀(x, u) + f_θ([x, u]): ``nominal``
    F₀ on (K, nx) and (K, nu) batches, f_θ an MLP given as numpy (W, b) per
    layer, W (n_in, n_out) as a Flax ``Dense`` kernel, ``activation``
    (``"tanh"`` or ``"relu"``) after every layer but the last. The weights
    are float32 tensors on ``device`` (default the card), each layer a
    ``torch.nn.functional.linear``."""
    act = {"tanh": torch.tanh, "relu": torch.relu}[activation]
    dev = resolve_device(device)
    params = [(_weights(np.asarray(W).T, dev), _weights(b, dev)) for W, b in layers]

    def step(x, u):
        y = nominal(x, u)
        h = torch.cat([x, u], -1)
        for i, (Wt, b) in enumerate(params):
            h = torch.nn.functional.linear(h, Wt, b)
            if i + 1 < len(params):
                h = act(h)
        return y + h

    return lift_dynamics(step)


__all__ = [
    "FAMILIES",
    "TileStep",
    "atan_tile",
    "dynamic_bicycle_tile",
    "four_wheel_torque_tile",
    "kinematic_bicycle_tile",
    "lift_dynamics",
    "lift_dynamics_time_varying",
    "lift_linear",
    "lift_mlp_residual",
    "unicycle_tile",
]
