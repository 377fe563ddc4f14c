"""Ready-made problem configurations.

:func:`flagship` is the counterpart of ``__graft_entry__.py:25 _flagship``:
diff-drive MPPI, unicycle with Euler steps at dt 0.02, exploration
temperature (1/1e-4), SUM cost, moving-average-edge filter of window 10, a
W = 20 waypoint window over a 200-point line from (0, 0) to (20, −10).

:func:`racecar_mppi` is the counterpart of the JAX package's
``presets.racecar_mppi``: the race car (kinematic bicycle, polygon
collision) as one :class:`MPPISolver` and its params.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .config import (
    CostAccumulation,
    MPPIConfig,
    MPPIParams,
    SmoothingFilter,
    Temperature,
    params_from_numpy,
)
from .models.dynamics import BicycleParams, kinematic_bicycle, unicycle
from .models.integrators import euler_step
from .solvers.mppi import (
    MPPISolver,
    make_cuda_bicycle_rollout,
    make_cuda_bicycle_tick,
    make_tracking_costs,
)


def flagship(num_samples: int = 10240, horizon: int = 50, device="cpu"):
    """(cfg, params, step_fn, stage_cost, terminal_cost) of the flagship
    diff-drive tracking problem, with params on ``device``."""
    dt = 0.02  # 50 Hz control budget
    cfg = MPPIConfig(
        num_samples=num_samples,
        horizon=horizon,
        dim_x=3,
        dim_u=2,
        dt=dt,
        lam=1.0,
        alpha=0.2,
        exploration=0.0001,
        temperature=Temperature.EXPLORATION,
        accumulation=CostAccumulation.SUM,
        filter=SmoothingFilter.MOVING_AVERAGE_EDGE,
        filter_window=10,
        waypoint_search_len=20,
    )

    n_pts = 200
    # built in float64 numpy and rounded once, like the JAX preset
    path = np.stack(
        [
            np.linspace(0.0, 20.0, n_pts),
            np.linspace(0.0, -10.0, n_pts),
            np.full(n_pts, np.arctan2(-10.0, 20.0)),
        ],
        axis=1,
    )
    params = params_from_numpy(
        sigma=[[0.1, 0.0], [0.0, 0.01]],
        stage_weight=[5.0, 5.0, 10.0],
        terminal_weight=[5.0, 5.0, 10.0],
        u_min=[-5.0, -3.14],
        u_max=[5.0, 3.14],
        ref_path=path,
        device=device,
    )

    def step_fn(x, u):
        return euler_step(unicycle, x, u, dt)

    stage, terminal = make_tracking_costs(cfg)
    return cfg, params, step_fn, stage, terminal


def _lane_rounded_samples(num_samples: int) -> int:
    """K rounded up to a multiple of 128: the hash noise stream lays the
    samples out as (K/128, 128) rows, as the JAX kernels' lanes do."""
    return -(-num_samples // 128) * 128


def racecar_mppi(
    ref_path,
    num_samples: int = 100,
    horizon: int = 10,
    dt: float = 0.05,
    wheel_base: float = 2.5,
    obstacles=None,
    use_kernel: bool = False,
    fused_tick: bool = False,
    gaussian: str = "hash",
    iso_xy: Optional[bool] = None,
    sincos: str = "native",
    device="cpu",
    **overrides,
) -> tuple[MPPISolver, MPPIParams]:
    """Race-car MPPI (kinematic bicycle) with polygon collision when
    ``obstacles`` (n, 3) are given.

    The JAX preset's defaults: dt = 0.05, L = 2.5, λ = 50, α = 1,
    exploration 0.01, Σ = diag(0.5, 0.1), 4-term weights (50, 50, 1, 20),
    steer ±0.523, accel ±2.0, a 4 × 3 m vehicle with a 1.5 safety margin,
    SUM cost, the padded moving-average filter, W = 200. ``fused_tick``
    binds the fused bicycle tick, ``use_kernel`` the split bicycle rollout;
    either rounds K up to a multiple of 128. ``iso_xy`` None enables the
    symmetric-weight specialization exactly when the weights are symmetric.
    The TPU-only ``gaussian`` and ``sincos`` modes raise ``ValueError``, as
    in :class:`MPPISolver`.
    ``solver.dynamics_step`` is the Euler bicycle step, the plant of a
    closed loop. ``ref_path`` and ``obstacles`` may be tensors or arrays;
    the params live on ``device``."""
    if fused_tick or use_kernel:
        num_samples = _lane_rounded_samples(num_samples)
    kw = dict(
        num_samples=num_samples,
        horizon=horizon,
        dim_x=4,
        dim_u=2,
        dt=dt,
        lam=50.0,
        alpha=1.0,
        exploration=0.01,
        temperature=Temperature.LAMBDA,
        accumulation=CostAccumulation.SUM,
        filter=SmoothingFilter.MOVING_AVERAGE_PADDED,
        filter_window=min(10, horizon),
        waypoint_search_len=200,
    )
    kw.update(overrides)
    cfg = MPPIConfig(**kw)
    weights = [50.0, 50.0, 1.0, 20.0]

    def f32(a):
        return None if a is None else torch.as_tensor(a, dtype=torch.float32).to(device)

    params = MPPIParams(
        sigma=f32([[0.5, 0.0], [0.0, 0.1]]),
        stage_weight=f32(weights),
        terminal_weight=f32(weights),
        u_min=f32([-0.523, -2.0]),
        u_max=f32([0.523, 2.0]),
        ref_path=f32(ref_path),
        obstacles=f32(obstacles),
    )
    if iso_xy is None:
        iso_xy = weights[0] == weights[1]
    bp = BicycleParams(wheel_base=wheel_base)

    def step(x, u):
        return euler_step(lambda s, a: kinematic_bicycle(s, a, bp), x, u, dt)

    stage, terminal = make_tracking_costs(
        cfg,
        wrap_yaw=True,
        collision="none" if obstacles is None else "polygon",
        vehicle_length=4.0,
        vehicle_width=3.0,
        safety_margin_rate=1.5,
    )
    rollout_fn = tick_fn = None
    if fused_tick:
        tick_fn = make_cuda_bicycle_tick(
            cfg, wheel_base=wheel_base, gaussian=gaussian, iso_xy=iso_xy, sincos=sincos
        )
    elif use_kernel:
        rollout_fn = make_cuda_bicycle_rollout(cfg, wheel_base=wheel_base)
    solver = MPPISolver(cfg, step, stage, terminal, rollout_fn=rollout_fn, tick_fn=tick_fn,
                        gaussian=gaussian, sincos=sincos, device=device)
    return solver, params


__all__ = ["flagship", "racecar_mppi"]
