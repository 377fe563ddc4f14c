"""Split diff-drive rollout: ε in, per-sample cost S out.

Counterpart of ``dnn_mppi_mpc_tpu/ops/pallas/rollout.py:146
diffdrive_rollout_costs``. On CUDA tensors :func:`diffdrive_rollout_costs`
launches ``dmm_rollout_costs`` (csrc/mppi_kernels.cu); on CPU tensors it
runs :func:`diffdrive_rollout_costs_plain`, the same computation in plain
PyTorch. The JAX kernel's semantics: exploration split, in-rollout clamp,
γ·uᵀΣ⁻¹v energy term, running-min nearest waypoint, static circle
obstacles (robot radius × safety margin), SUM or LAST accumulation.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..._build import DmmArgs, launch
from .common import check, f32, on_cuda, rollout_body_plain
from .mppi_tick import effective_robot_radius, pack_obstacles


def diffdrive_rollout_costs_plain(
    eps, u, a, x0, window, stage_w, term_w, u_min, u_max, dt, n_exploit,
    obstacles=None, robot_radius=0.5, safety_margin_rate=1.5, k_offset=0.0,
    *, T: int, W: int, last_only: bool = False,
) -> torch.Tensor:
    """Plain PyTorch version of :func:`diffdrive_rollout_costs`."""
    diffdrive_rollout_costs_plain.calls += 1
    return rollout_body_plain(
        eps, u, a, x0, window[:W], stage_w, term_w, u_min, u_max,
        dt=dt, n_exploit=n_exploit, k_offset=k_offset,
        obstacles=pack_obstacles(obstacles, None)[0], obs_mode="circle",
        obs_radius=effective_robot_radius(robot_radius, safety_margin_rate),
        last_only=last_only,
    )


diffdrive_rollout_costs_plain.calls = 0


def launch_rollout(eps, u, a, x0, window, stage_w, term_w, u_min, u_max, dt, n_exploit,
                   obstacles, robot_radius, safety_margin_rate, k_offset, *, T: int, W: int,
                   last_only: bool) -> torch.Tensor:
    """Check the inputs, allocate S and launch ``dmm_rollout_costs``."""
    dev = u.device
    K = eps.shape[0]
    check("eps", eps, (K, T, 2), dev)
    eps_t = eps.transpose(0, 1).contiguous()  # (T, K, 2): coalesced per step
    obs, n_obs = pack_obstacles(obstacles, None)
    S = torch.empty(K, dtype=torch.float32, device=dev)
    args = DmmArgs(
        u=check("u", u, (T, 2), dev),
        a=check("a", a, (T, 2), dev),
        x0=check("x0", x0, (3,), dev),
        window=check("window", window, (W, 3), dev),
        stage_w=check("stage_w", stage_w, (3,), dev),
        term_w=check("term_w", term_w, (3,), dev),
        u_min=check("u_min", u_min, (2,), dev),
        u_max=check("u_max", u_max, (2,), dev),
        obstacles=check("obstacles", obs, (n_obs, 5), dev),
        eps=eps_t.data_ptr(),
        S=S.data_ptr(),
        K=K, T=T, W=W, n_obs=n_obs, eps_mode=0, last_only=int(last_only),
        dt=f32(dt), n_exploit=f32(n_exploit), k_offset=f32(k_offset),
        obs_radius=f32(effective_robot_radius(robot_radius, safety_margin_rate)),
    )
    launch("dmm_rollout_costs", args, dev)
    return S


def diffdrive_rollout_costs(
    eps: torch.Tensor,  # (K, T, 2) noise
    u: torch.Tensor,  # (T, 2) nominal sequence
    a: torch.Tensor,  # (T, 2) γ·u_tᵀΣ⁻¹
    x0: torch.Tensor,  # (3,)
    window: torch.Tensor,  # (W, 3) waypoint window
    stage_w: torch.Tensor,  # (3,)
    term_w: torch.Tensor,  # (3,)
    u_min: torch.Tensor,  # (2,)
    u_max: torch.Tensor,  # (2,)
    dt: float,
    n_exploit: float,
    obstacles: Optional[torch.Tensor] = None,  # (n_obs, 3) or None
    robot_radius: float = 0.5,  # physical radius; the margin is applied here
    safety_margin_rate: float = 1.5,
    k_offset: float = 0.0,
    *,
    T: int,
    W: int,
    last_only: bool = False,
) -> torch.Tensor:
    """Per-sample costs S (K,) of the split rollout."""
    if not on_cuda(u, eps=eps, a=a, x0=x0, window=window, obstacles=obstacles):
        return diffdrive_rollout_costs_plain(
            eps, u, a, x0, window, stage_w, term_w, u_min, u_max, dt, n_exploit,
            obstacles, robot_radius, safety_margin_rate, k_offset,
            T=T, W=W, last_only=last_only,
        )
    S = launch_rollout(eps, u, a, x0, window, stage_w, term_w, u_min, u_max, dt, n_exploit,
                       obstacles, robot_radius, safety_margin_rate, k_offset, T=T, W=W,
                       last_only=last_only)
    diffdrive_rollout_costs.launches += 1
    return S


diffdrive_rollout_costs.launches = 0

__all__ = ["diffdrive_rollout_costs", "diffdrive_rollout_costs_plain"]
