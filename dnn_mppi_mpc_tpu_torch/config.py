"""Typed configuration for the PyTorch/CUDA MPPI engine.

Counterpart of ``dnn_mppi_mpc_tpu/config.py``. The split is the same:

* **static config** — frozen, hashable dataclasses that fix shapes and code
  paths (sample count K, horizon T, temperature convention, filter kind);
* **runtime params** — :class:`MPPIParams`, a dataclass of tensors that can
  change between ticks without rebuilding anything.

The enums and :class:`MPPIConfig` carry the JAX package's fields, with
``use_pallas`` renamed ``use_kernel``; the fields of the per-rollout
waypoint carry (``waypoint_persist``, ``carry_window_len``) come with that
mode.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Optional

import numpy as np
import torch


class Temperature(enum.Enum):
    """Softmax inverse-temperature convention (weight ∝ exp(-(S-ρ)/λ) for
    ``LAMBDA``, exp(-(S-ρ)/exploration) for ``EXPLORATION``)."""

    LAMBDA = "lambda"
    EXPLORATION = "exploration"


class CostAccumulation(enum.Enum):
    """``SUM`` accumulates every stage cost; ``LAST`` keeps only the last
    stage cost (plus terminal), the reference's ``S[k] =`` overwrite quirk."""

    SUM = "sum"
    LAST = "last"


class SmoothingFilter(enum.Enum):
    """Smoothing filter applied to the weighted-noise update."""

    MOVING_AVERAGE_EDGE = "ma_edge"
    MOVING_AVERAGE_PADDED = "ma_padded"
    SAVGOL = "savgol"
    NONE = "none"


@dataclasses.dataclass(frozen=True)
class MPPIConfig:
    """Static MPPI solver configuration (fields as in the JAX package).

    ``waypoint_carry="rollout"`` is not implemented yet: the solver rejects
    it with ``ValueError`` rather than ignoring it.
    """

    num_samples: int  # K
    horizon: int  # T
    dim_x: int
    dim_u: int
    dt: float
    lam: float = 1.0  # λ, information-theoretic temperature
    alpha: float = 0.2  # γ = λ(1-α)
    exploration: float = 0.0001  # pure-noise sample fraction AND alt temperature
    temperature: Temperature = Temperature.LAMBDA
    accumulation: CostAccumulation = CostAccumulation.SUM
    filter: SmoothingFilter = SmoothingFilter.MOVING_AVERAGE_EDGE
    filter_window: int = 10
    savgol_polyorder: int = 3
    waypoint_search_len: int = 20  # W
    num_rollout_repeats: int = 1  # M (scan path only)
    rollout_var_cost: float = 0.0
    rollout_var_discount: float = 0.95
    use_kernel: bool = False  # split CUDA rollout kernel on the scan path
    waypoint_carry: str = "tick"  # only "tick" is implemented
    time_varying_dynamics: bool = False  # dynamics_step(x, u, t) (scan path)
    compute_optimal_traj: bool = False  # (T, nx) diagnostic rollout of u_new

    @property
    def gamma(self) -> float:
        return self.lam * (1.0 - self.alpha)

    @property
    def inv_temperature(self) -> float:
        if self.temperature == Temperature.LAMBDA:
            return 1.0 / self.lam
        return 1.0 / self.exploration


@dataclasses.dataclass
class MPPIParams:
    """Runtime MPPI parameters: a dataclass of float32 tensors.

    ``sigma`` is Σ (dim_u × dim_u); ``u_min``/``u_max`` clamp the controls
    inside the rollout; ``stage_weight``/``terminal_weight`` are diagonal
    tracking weights; ``ref_path`` is the (P, d) waypoint table;
    ``obstacles`` (n, 3) are circles (x, y, r) and ``obstacle_velocities``
    (n, 2) make them drift during the rollout; ``control_weight`` (dim_u,) adds
    Σⱼ rⱼ·vⱼ² of the clamped action to each stage cost.
    """

    sigma: torch.Tensor
    stage_weight: torch.Tensor
    terminal_weight: torch.Tensor
    u_min: torch.Tensor
    u_max: torch.Tensor
    ref_path: torch.Tensor
    obstacles: Optional[torch.Tensor] = None
    obstacle_velocities: Optional[torch.Tensor] = None
    control_weight: Optional[torch.Tensor] = None

    def to(self, device) -> "MPPIParams":
        """A copy with every tensor moved to ``device``."""
        return MPPIParams(
            **{
                f.name: None if getattr(self, f.name) is None
                else getattr(self, f.name).to(device)
                for f in dataclasses.fields(self)
            }
        )


def params_from_numpy(
    sigma,
    stage_weight,
    terminal_weight,
    u_min,
    u_max,
    ref_path,
    obstacles=None,
    obstacle_velocities=None,
    model_params=None,
    control_weight=None,
    *,
    device="cpu",
) -> MPPIParams:
    """Build :class:`MPPIParams` on ``device`` from the JAX package's
    ``MPPIParams`` leaves given as numpy arrays (in their field order)."""
    if model_params is not None:
        raise ValueError("model_params (learned/custom dynamics) is not ported yet")

    def f32(a):
        if a is None:
            return None
        return torch.tensor(np.asarray(a, np.float32), device=device)

    return MPPIParams(
        sigma=f32(sigma),
        stage_weight=f32(stage_weight),
        terminal_weight=f32(terminal_weight),
        u_min=f32(u_min),
        u_max=f32(u_max),
        ref_path=f32(ref_path),
        obstacles=f32(obstacles),
        obstacle_velocities=f32(obstacle_velocities),
        control_weight=f32(control_weight),
    )


__all__ = [
    "Temperature",
    "CostAccumulation",
    "SmoothingFilter",
    "MPPIConfig",
    "MPPIParams",
    "params_from_numpy",
]
