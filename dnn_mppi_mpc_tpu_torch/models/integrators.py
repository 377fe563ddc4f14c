"""Explicit integrators (counterpart of ``dnn_mppi_mpc_tpu/models/integrators.py``)."""

from __future__ import annotations

from typing import Callable

import torch

Dynamics = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]


def euler_step(f: Dynamics, x: torch.Tensor, u: torch.Tensor, dt: float) -> torch.Tensor:
    """Forward-Euler step, the MPPI rollout integrator."""
    return x + f(x, u) * dt


def rk4_step(f: Dynamics, x: torch.Tensor, u: torch.Tensor, dt: float) -> torch.Tensor:
    """Classic RK4 step."""
    k1 = f(x, u)
    k2 = f(x + 0.5 * dt * k1, u)
    k3 = f(x + 0.5 * dt * k2, u)
    k4 = f(x + dt * k3, u)
    return x + dt / 6.0 * (k1 + 2.0 * k2 + 2.0 * k3 + k4)


__all__ = ["euler_step", "rk4_step"]
