"""Ready-made problem configurations.

:func:`flagship` is the counterpart of ``__graft_entry__.py:25 _flagship``:
diff-drive MPPI, unicycle with Euler steps at dt 0.02, exploration
temperature (1/1e-4), SUM cost, moving-average-edge filter of window 10, a
W = 20 waypoint window over a 200-point line from (0, 0) to (20, −10).
"""

from __future__ import annotations

import numpy as np

from .config import (
    CostAccumulation,
    MPPIConfig,
    SmoothingFilter,
    Temperature,
    params_from_numpy,
)
from .models.dynamics import unicycle
from .models.integrators import euler_step
from .solvers.mppi import make_tracking_costs


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


__all__ = ["flagship"]
