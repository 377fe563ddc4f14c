"""Plants: simulated vehicles that close the control loop (counterpart of
``dnn_mppi_mpc_tpu/envs/plants.py``).

* :class:`Plant`: an integrator plant (Euler as in the MPPI demos, RK4, or
  ERK = RK4 × substeps as acados' AcadosSimSolver) with the gym-style
  ``Vehicle`` env's input delay and noise hooks (the reference's
  models/vehicle.py:85-115);
* :class:`WheelPlant`: the diff-drive robot actuated at its wheels, the
  forward twin of ``kinematics.diff_drive_wheel_speeds``.

The JAX plants' jitted methods are plain methods on tensors here, batched
over leading dims. Their PRNG key is a ``torch.Generator`` on the plant's
device, seeded by the caller: noise repeats itself under one seed and has
the stated moments, but it is not JAX's stream. A state's generator
advances in place, so a state and its successor share it. Each plant runs
on the card unless the caller passes ``device="cpu"``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from ..config import resolve_device
from ..models.integrators import erk_step, euler_step, rk4_step
from .kinematics import HUSKY_WHEEL_SEP, diff_drive_wheel_speeds

Dynamics = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]

# π and 2π as float32 rounds them, the constants JAX's float32 wrap uses
_PI_F32 = float(np.float32(np.pi))
_TWO_PI_F32 = float(np.float32(2.0 * np.pi))


def wrap_to_pi(yaw: torch.Tensor) -> torch.Tensor:
    """Yaw wrapped to [−π, π) as ``mod(yaw + π, 2π) − π`` in float32.

    PyBullet reports (−π, π] (getEulerFromQuaternion); the two differ only
    at ±π. This is the JAX plant's formula, rounding for rounding
    (``torch.remainder`` is fmod with the sign fix-up, as ``jnp.mod``), and
    deliberately not the algebraic twin π − mod(π − yaw, 2π): the two differ
    by about an ulp a wrap, and the reference protocol's closed loop is
    chaotic enough that such an ulp moved its setpoint-convergence gate
    from 42 to 21 converged runs."""
    return torch.remainder(yaw + _PI_F32, _TWO_PI_F32) - _PI_F32


def _tensor_on(a, device) -> Optional[torch.Tensor]:
    return None if a is None else torch.as_tensor(a, dtype=torch.float32).to(device)


def _generator(device: torch.device, seed: int) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(seed)


def _delayed(u_buffer: torch.Tensor, u: torch.Tensor, delay_steps: int):
    """(command applied now, next buffer): with a delay the buffer is
    (delay, ..., nu), oldest command first, and ``u`` joins at its end."""
    if delay_steps > 0:
        return u_buffer[0], torch.cat([u_buffer[1:], u[None]], dim=0)
    return u, u_buffer


def _noisy(x: torch.Tensor, std: Optional[torch.Tensor], gen: torch.Generator) -> torch.Tensor:
    if std is None:
        return x
    return x + std * torch.randn(x.shape, generator=gen, dtype=x.dtype, device=x.device)


@dataclasses.dataclass
class PlantState:
    """x: (..., nx) state; u_buffer: (delay, ..., nu) pending inputs;
    generator: the noise stream."""

    x: torch.Tensor
    u_buffer: torch.Tensor
    generator: torch.Generator


class Plant:
    """Integrator plant with optional input delay and additive noise.

    ``delay_steps`` makes inputs act after a fixed buffer delay;
    ``process_noise_std`` and ``measurement_noise_std`` (broadcast against x)
    add Gaussian noise to the state after each step and to each reading.
    ``method`` 'euler', 'rk4' or 'erk' (RK4 × ``num_steps``)."""

    def __init__(
        self,
        dynamics: Dynamics,
        dt: float,
        method: str = "euler",
        num_steps: int = 3,
        delay_steps: int = 0,
        process_noise_std=None,
        measurement_noise_std=None,
        device="cuda",
    ) -> None:
        self.device = resolve_device(device)
        self.dynamics = dynamics
        self.dt = dt
        self.delay_steps = delay_steps
        self.process_noise_std = _tensor_on(process_noise_std, self.device)
        self.measurement_noise_std = _tensor_on(measurement_noise_std, self.device)
        if method == "euler":
            self._step = lambda x, u: euler_step(dynamics, x, u, dt)
        elif method == "rk4":
            self._step = lambda x, u: rk4_step(dynamics, x, u, dt)
        elif method == "erk":
            self._step = lambda x, u: erk_step(dynamics, x, u, dt, num_steps=num_steps)
        else:
            raise ValueError(f"unknown integrator {method!r}")

    def init(self, x0, dim_u: int, seed: int = 0) -> PlantState:
        """The plant at x0 (..., nx), the delay buffer zero, the noise stream
        seeded by ``seed``."""
        x0 = torch.as_tensor(x0, dtype=torch.float32).to(self.device)
        buf = torch.zeros((max(self.delay_steps, 1),) + x0.shape[:-1] + (dim_u,),
                          dtype=x0.dtype, device=self.device)
        return PlantState(x=x0, u_buffer=buf, generator=_generator(self.device, seed))

    def step(self, state: PlantState, u: torch.Tensor) -> PlantState:
        u_applied, buf = _delayed(state.u_buffer, u, self.delay_steps)
        x = _noisy(self._step(state.x, u_applied), self.process_noise_std, state.generator)
        return PlantState(x=x, u_buffer=buf, generator=state.generator)

    def measure(self, state: PlantState) -> Tuple[torch.Tensor, PlantState]:
        """A reading of the state, with measurement noise when configured."""
        return _noisy(state.x, self.measurement_noise_std, state.generator), state


@dataclasses.dataclass
class WheelPlantState:
    """pose (..., 3); wheel_speeds (..., 4) lag state; pending commands;
    the noise stream."""

    x: torch.Tensor
    wheel_speeds: torch.Tensor
    u_buffer: torch.Tensor
    generator: torch.Generator


class WheelPlant:
    """Actuation-level diff-drive plant: WHEEL-speed commands → body pose.

    The reference's deployment loops actuate wheels, not the body twist: the
    controller's (v, ω) goes through inverse kinematics to four wheel-speed
    targets that PyBullet's velocity-controlled joints track. Here:

    * a first-order lag a wheel with time constant ``tau``, α = 1 − exp(−dt/τ);
    * a command delay of ``delay_steps`` (buffer (delay, ..., 4), oldest
      first) and a speed ``cap``;
    * ``slip`` on the differential (turning) mode and separate
      ``common_gain`` / ``diff_gain`` execution gains, the calibration
      handles of the recorded acados run;
    * additive pose process noise; yaw wrapped by :func:`wrap_to_pi`.

    Wheel order (fl, fr, rl, rr). Forward kinematics: left = (fl + rl)/2,
    right = (fr + rr)/2, v = common_gain·(left + right)/2,
    ω = diff_gain·slip·(right − left)/L."""

    def __init__(
        self,
        dt: float,
        wheel_sep: float = HUSKY_WHEEL_SEP,
        tau: float = 0.0,
        delay_steps: int = 0,
        wheel_speed_cap: Optional[float] = None,
        slip: float = 1.0,
        common_gain: float = 1.0,
        diff_gain: float = 1.0,
        process_noise_std=None,
        wrap_yaw: bool = True,
        device="cuda",
    ) -> None:
        self.device = resolve_device(device)
        self.dt = dt
        self.wheel_sep = wheel_sep
        self.tau = tau
        self.delay_steps = delay_steps
        self.wheel_speed_cap = wheel_speed_cap
        self.slip = slip
        self.common_gain = common_gain
        self.diff_gain = diff_gain
        self.process_noise_std = _tensor_on(process_noise_std, self.device)
        self.wrap_yaw = wrap_yaw

    def init(self, x0, seed: int = 0) -> WheelPlantState:
        """The robot at pose x0 (..., 3), wheels at rest."""
        x0 = torch.as_tensor(x0, dtype=torch.float32).to(self.device)
        shape = x0.shape[:-1] + (4,)
        return WheelPlantState(
            x=x0,
            wheel_speeds=torch.zeros(shape, dtype=x0.dtype, device=self.device),
            u_buffer=torch.zeros((max(self.delay_steps, 1),) + shape, dtype=x0.dtype,
                                 device=self.device),
            generator=_generator(self.device, seed),
        )

    def step(self, state: WheelPlantState, wheel_cmds: torch.Tensor) -> WheelPlantState:
        """One control period under (..., 4) wheel-speed commands."""
        cmd, buf = _delayed(state.u_buffer, wheel_cmds, self.delay_steps)
        if self.wheel_speed_cap is not None:
            cmd = torch.clamp(cmd, -self.wheel_speed_cap, self.wheel_speed_cap)
        if self.tau > 0.0:
            alpha = 1.0 - math.exp(-self.dt / self.tau)
            w = state.wheel_speeds + alpha * (cmd - state.wheel_speeds)
        else:
            w = cmd
        left = 0.5 * (w[..., 0] + w[..., 2])
        right = 0.5 * (w[..., 1] + w[..., 3])
        v = self.common_gain * 0.5 * (left + right)
        omega = self.diff_gain * self.slip * (right - left) / self.wheel_sep
        yaw = state.x[..., 2]
        x = state.x + self.dt * torch.stack(
            [v * torch.cos(yaw), v * torch.sin(yaw), omega], dim=-1
        )
        if self.wrap_yaw:
            x = torch.cat([x[..., :2], wrap_to_pi(x[..., 2:3]), x[..., 3:]], dim=-1)
        x = _noisy(x, self.process_noise_std, state.generator)
        return WheelPlantState(x=x, wheel_speeds=w, u_buffer=buf, generator=state.generator)

    def step_body(self, state: WheelPlantState, u: torch.Tensor) -> WheelPlantState:
        """A body-twist command (v, ω) → inverse kinematics → wheel step: the
        reference's control loop (solve → IK → joints)."""
        return self.step(state, diff_drive_wheel_speeds(u[..., 0], u[..., 1], self.wheel_sep))


__all__ = ["Plant", "PlantState", "WheelPlant", "WheelPlantState", "wrap_to_pi"]
