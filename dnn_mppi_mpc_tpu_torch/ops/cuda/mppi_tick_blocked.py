"""K-blocked diff-drive MPPI tick for pod-scale sample counts.

Counterpart of ``dnn_mppi_mpc_tpu/ops/pallas/mppi_tick_blocked.py:317
diffdrive_mppi_tick_blocked``. What carries over is the noise-stream
contract: the ε of sample k = b·K_BLK + r·128 + lane at step t is position
(t, r, lane) of ``hash_normal_pair(seed, b, (T, K_BLK/128, 128))``, bit for
bit the JAX kernel's ``gaussian="hash"`` stream. What does not: the TPU runs
the K blocks in order and merges them with an online softmax; on the card
the blocks run in parallel, so ρ and η come from the same two-pass reduction
as the fused tick, and the Σw·ε pass draws ε again from the stream instead of
reading a stored (T, K, 2) buffer. On CUDA tensors
:func:`diffdrive_mppi_tick_blocked` launches ``dmm_mppi_tick`` in that mode;
on CPU tensors it runs :func:`diffdrive_mppi_tick_blocked_plain`.
"""

from __future__ import annotations

from typing import Optional

import torch

from .common import on_cuda, rollout_body_plain, softmax_plain, weighted_noise_plain
from .mathx import hash_noise
from .mppi_tick import effective_robot_radius, launch_tick, pack_obstacles


def _check_blocks(K: int, K_BLK: int) -> None:
    if K_BLK % 128 or K % K_BLK:
        raise ValueError(f"need K_BLK % 128 == 0 and K % K_BLK == 0 (K={K}, K_BLK={K_BLK})")


def diffdrive_mppi_tick_blocked_plain(
    seed, u, a, chol_sigma, x0, window, stage_w, term_w, u_min, u_max, dt,
    n_exploit, inv_temperature, obstacles=None, robot_radius=0.5,
    safety_margin_rate=1.5, obstacle_velocities=None, soft_safety_distance=2.0,
    soft_weight=100.0, *, K: int, T: int, W: int, K_BLK: int = 10240,
    last_only: bool = False, collision: str = "circle", iso_xy: bool = False,
):
    """Plain PyTorch version of :func:`diffdrive_mppi_tick_blocked`."""
    diffdrive_mppi_tick_blocked_plain.calls += 1
    _check_blocks(K, K_BLK)
    eps = hash_noise(seed, chol_sigma, K, T, K_BLK)
    obs, _ = pack_obstacles(obstacles, obstacle_velocities)
    S = rollout_body_plain(
        eps, u, a, x0, window, stage_w, term_w, u_min, u_max,
        dt=dt, n_exploit=n_exploit, obstacles=obs, obs_mode=collision,
        obs_radius=effective_robot_radius(robot_radius, safety_margin_rate),
        drift=obstacle_velocities is not None, soft_dist=soft_safety_distance,
        soft_w=soft_weight, iso_xy=iso_xy, last_only=last_only,
    )
    rho, eta, w = softmax_plain(S, inv_temperature)
    return S, rho, eta, weighted_noise_plain(w, eps)


diffdrive_mppi_tick_blocked_plain.calls = 0


def diffdrive_mppi_tick_blocked(
    seed: torch.Tensor,  # (1,) int64 holding the uint32 seed
    u: torch.Tensor,
    a: torch.Tensor,
    chol_sigma: torch.Tensor,
    x0: torch.Tensor,
    window: torch.Tensor,
    stage_w: torch.Tensor,
    term_w: torch.Tensor,
    u_min: torch.Tensor,
    u_max: torch.Tensor,
    dt: float,
    n_exploit: float,
    inv_temperature: float,
    obstacles: Optional[torch.Tensor] = None,
    robot_radius: float = 0.5,  # physical radius; the margin is applied here
    safety_margin_rate: float = 1.5,
    obstacle_velocities: Optional[torch.Tensor] = None,
    soft_safety_distance: float = 2.0,
    soft_weight: float = 100.0,
    *,
    K: int,
    T: int,
    W: int,
    K_BLK: int = 10240,
    last_only: bool = False,
    collision: str = "circle",
    iso_xy: bool = False,
):
    """Fused MPPI tick over K = NB·K_BLK samples with per-block hash ε.
    Returns ``(S (K,), rho (), eta (), w_eps (T, 2))``."""
    _check_blocks(K, K_BLK)
    if not on_cuda(u, seed=seed, window=window, x0=x0, obstacles=obstacles):
        return diffdrive_mppi_tick_blocked_plain(
            seed, u, a, chol_sigma, x0, window, stage_w, term_w, u_min, u_max,
            dt, n_exploit, inv_temperature, obstacles, robot_radius,
            safety_margin_rate, obstacle_velocities, soft_safety_distance,
            soft_weight, K=K, T=T, W=W, K_BLK=K_BLK, last_only=last_only,
            collision=collision, iso_xy=iso_xy,
        )
    out = launch_tick(
        seed=seed, u=u, a=a, chol_sigma=chol_sigma, x0=x0, window=window,
        stage_w=stage_w, term_w=term_w, u_min=u_min, u_max=u_max, dt=dt,
        n_exploit=n_exploit, inv_temperature=inv_temperature,
        obstacles=obstacles, obstacle_velocities=obstacle_velocities,
        robot_radius=robot_radius, safety_margin_rate=safety_margin_rate,
        soft_safety_distance=soft_safety_distance, soft_weight=soft_weight,
        control_weight=None, filter_t=None, eps=None, eps_mode=2, k_blk=K_BLK,
        K=K, T=T, W=W, last_only=last_only, collision=collision, iso_xy=iso_xy,
    )
    diffdrive_mppi_tick_blocked.launches += 1
    return out["S"], out["stats"][0], out["stats"][1], out["w_eps"]


diffdrive_mppi_tick_blocked.launches = 0

__all__ = ["diffdrive_mppi_tick_blocked", "diffdrive_mppi_tick_blocked_plain"]
