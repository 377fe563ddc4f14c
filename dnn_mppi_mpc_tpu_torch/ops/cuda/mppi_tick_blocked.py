"""K-blocked diff-drive MPPI tick for pod-scale sample counts, the two phases
of the sample-sharded tick, and the fleet tick.

Counterpart of ``dnn_mppi_mpc_tpu/ops/pallas/mppi_tick_blocked.py``:

* :func:`diffdrive_mppi_tick_blocked` (``:317``). What carries over is the
  noise-stream contract: the ε of sample k = b·K_BLK + r·128 + lane at step t
  is position (t, r, lane) of ``hash_normal_pair(seed, block_offset + b,
  (T, K_BLK/128, 128))``, bit for bit the JAX kernel's ``gaussian="hash"``
  stream. What does not: the TPU runs the K blocks in order and merges them
  with an online softmax; on the card the rollout's blocks run in parallel,
  and then grid passes over chunks of K give each chunk its min and its
  Σ exp(−λ(S − min)), merged into ρ and η in chunk order, and Σw·ε on a
  grid of chunks × steps draws ε again from the stream instead of reading
  a stored (T, K, 2) buffer (csrc/mppi_reductions.cuh; the fused tick's
  reductions too). ``s_only`` stops after the rollout: phase 1 of the
  sharded tick.
* :func:`weighted_noise_reduce` (``:475``): Σₖ wₖ·εₖ with ε drawn again from
  the same stream, phase 2 of the sharded tick. It runs the K-blocked tick's
  Σw·ε grid over chunks × steps on the weights it is given (no softmax),
  then the chunk sum in chunk order: given that tick's own w (same seed,
  offset and K_BLK) it returns that tick's Σw·ε bit for bit.
* :func:`fleet_mppi_tick` (``:618``): B complete ticks in one call, member b
  drawing its ε from ``seeds[b]`` (one block of K samples); the rollout,
  the softmax and Σw·ε each one grid over all members.

On CUDA tensors each wrapper launches its kernel (``dmm_mppi_tick``,
``dmm_weighted_noise_reduce``, ``dmm_fleet_mppi_tick`` in
csrc/mppi_kernels.cu); on CPU tensors it runs its ``*_plain`` version.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..._build import DmmArgs, DmmFleetArgs, launch
from .common import (
    check,
    check_seed,
    f32,
    on_cuda,
    rollout_body_plain,
    softmax_plain,
    weighted_noise_plain,
)
from .mathx import hash_noise
from .mppi_tick import (
    _OBS_MODES,
    chunk_scratch_floats,
    effective_robot_radius,
    launch_tick,
    pack_obstacles,
)


def _check_blocks(K: int, K_BLK: int) -> None:
    if K_BLK % 128 or K % K_BLK:
        raise ValueError(f"need K_BLK % 128 == 0 and K % K_BLK == 0 (K={K}, K_BLK={K_BLK})")


def diffdrive_mppi_tick_blocked_plain(
    seed, u, a, chol_sigma, x0, window, stage_w, term_w, u_min, u_max, dt,
    n_exploit, inv_temperature, obstacles=None, robot_radius=0.5,
    safety_margin_rate=1.5, obstacle_velocities=None, soft_safety_distance=2.0,
    soft_weight=100.0, k_offset=0.0, block_offset=0, *, K: int, T: int, W: int,
    K_BLK: int = 10240, last_only: bool = False, s_only: bool = False,
    collision: str = "circle", iso_xy: bool = False,
):
    """Plain PyTorch version of :func:`diffdrive_mppi_tick_blocked`."""
    diffdrive_mppi_tick_blocked_plain.calls += 1
    _check_blocks(K, K_BLK)
    eps = hash_noise(seed, chol_sigma, K, T, K_BLK, block_offset)
    obs, _ = pack_obstacles(obstacles, obstacle_velocities)
    S = rollout_body_plain(
        eps, u, a, x0, window, stage_w, term_w, u_min, u_max,
        dt=dt, n_exploit=n_exploit, k_offset=k_offset, obstacles=obs, obs_mode=collision,
        obs_radius=effective_robot_radius(robot_radius, safety_margin_rate),
        drift=obstacle_velocities is not None, soft_dist=soft_safety_distance,
        soft_w=soft_weight, iso_xy=iso_xy, last_only=last_only,
    )
    if s_only:
        return S
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
    k_offset: float = 0.0,  # global index of the first sample (exploration split)
    block_offset: int = 0,  # global index of the first noise-stream block
    *,
    K: int,
    T: int,
    W: int,
    K_BLK: int = 10240,
    last_only: bool = False,
    s_only: bool = False,
    collision: str = "circle",
    iso_xy: bool = False,
):
    """Fused MPPI tick over K = NB·K_BLK samples with per-block hash ε.
    Returns ``(S (K,), rho (), eta (), w_eps (T, 2))``, or S alone when
    ``s_only`` (phase 1 of the sharded tick: a shard of K samples whose
    first sample is global sample ``k_offset`` and whose first block is
    global block ``block_offset``)."""
    _check_blocks(K, K_BLK)
    if not on_cuda(u, seed=seed, window=window, x0=x0, obstacles=obstacles):
        return diffdrive_mppi_tick_blocked_plain(
            seed, u, a, chol_sigma, x0, window, stage_w, term_w, u_min, u_max,
            dt, n_exploit, inv_temperature, obstacles, robot_radius,
            safety_margin_rate, obstacle_velocities, soft_safety_distance,
            soft_weight, k_offset, block_offset, K=K, T=T, W=W, K_BLK=K_BLK,
            last_only=last_only, s_only=s_only, collision=collision, iso_xy=iso_xy,
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
        k_offset=k_offset, block_offset=block_offset, s_only=s_only,
    )
    diffdrive_mppi_tick_blocked.launches += 1
    if s_only:
        return out["S"]
    return out["S"], out["stats"][0], out["stats"][1], out["w_eps"]


diffdrive_mppi_tick_blocked.launches = 0


# --- phase 2 of the sharded tick: Σ w·ε with ε drawn again ------------------


def weighted_noise_reduce_plain(seed, w, chol_sigma, block_offset=0, *, K: int, T: int,
                                K_BLK: int = 10240, emit_eps: bool = False):
    """Plain PyTorch version of :func:`weighted_noise_reduce`; ``emit_eps``
    also returns the ε (K, T, 2) it drew (as the JAX kernel's emit mode)."""
    weighted_noise_reduce_plain.calls += 1
    _check_blocks(K, K_BLK)
    eps = hash_noise(seed, chol_sigma, K, T, K_BLK, block_offset)
    w_eps = weighted_noise_plain(w, eps)
    return (w_eps, eps) if emit_eps else w_eps


weighted_noise_reduce_plain.calls = 0


def weighted_noise_reduce(
    seed: torch.Tensor,  # (1,) int64 holding the uint32 seed
    w: torch.Tensor,  # (K,) weights (normalized, or this shard's m/η)
    chol_sigma: torch.Tensor,  # (2, 2) lower Cholesky factor of Σ
    block_offset: int = 0,
    *,
    K: int,
    T: int,
    K_BLK: int = 10240,
) -> torch.Tensor:
    """Σₖ wₖ·εₖ → (T, 2), with ε of sample k drawn again from block
    ``block_offset + k // K_BLK`` of the stream seeded by ``seed``: the ε
    that :func:`diffdrive_mppi_tick_blocked` drew with the same seed and
    offset."""
    _check_blocks(K, K_BLK)
    if not on_cuda(w, seed=seed, chol_sigma=chol_sigma):
        return weighted_noise_reduce_plain(seed, w, chol_sigma, block_offset, K=K, T=T,
                                           K_BLK=K_BLK)
    w_eps = launch_weighted_noise_reduce(seed, w, chol_sigma, block_offset, K=K, T=T,
                                         K_BLK=K_BLK)
    weighted_noise_reduce.launches += 1
    return w_eps


def launch_weighted_noise_reduce(seed, w, chol_sigma, block_offset, *, K: int, T: int,
                                 K_BLK: int) -> torch.Tensor:
    """Check the inputs, allocate the output and the scratch the library
    sizes (``dmm_chunk_scratch_floats``) and launch
    ``dmm_weighted_noise_reduce``. Returns ``w_eps`` (T, 2); ``w`` is only
    read."""
    dev = w.device
    w_eps = torch.empty((T, 2), dtype=torch.float32, device=dev)
    n = chunk_scratch_floats(K, K_BLK, T)
    scratch = torch.empty(n, dtype=torch.float32, device=dev)
    args = DmmArgs(
        seed=check_seed(seed, dev), w=check("w", w, (K,), dev),
        chol=check("chol_sigma", chol_sigma, (2, 2), dev), w_eps=w_eps.data_ptr(),
        scratch=scratch.data_ptr(), scratch_floats=n,
        K=K, T=T, k_blk=K_BLK, block_offset=block_offset,
    )
    launch("dmm_weighted_noise_reduce", args, dev)
    return w_eps


weighted_noise_reduce.launches = 0


# --- the fleet: B complete ticks in one call ---------------------------------


def fleet_mppi_tick_plain(
    seeds, u, a, chol_sigma, x0, windows, stage_w, term_w, u_min, u_max, dt,
    n_exploit, inv_temperature, obstacles=None, robot_radius=0.5,
    safety_margin_rate=1.5, obstacle_velocities=None, soft_safety_distance=2.0,
    soft_weight=100.0, *, B: int, K: int, T: int, W: int, last_only: bool = False,
    collision: str = "circle", iso_xy: bool = False,
):
    """Plain PyTorch version of :func:`fleet_mppi_tick`: member b's tick is
    the single tick's plain rollout, softmax and Σ w·ε on member b's
    inputs."""
    fleet_mppi_tick_plain.calls += 1
    eps = hash_noise(seeds, chol_sigma, K, T, K, per_member=True)  # (B, K, T, 2)
    obs, _ = pack_obstacles(obstacles, obstacle_velocities)
    S, w, w_eps = [], [], []
    for b in range(B):
        S.append(rollout_body_plain(
            eps[b], u[b], a[b], x0[b], windows[b], stage_w, term_w, u_min, u_max,
            dt=dt, n_exploit=n_exploit, obstacles=None if obs is None else obs[b],
            obs_mode=collision,
            obs_radius=effective_robot_radius(robot_radius, safety_margin_rate),
            drift=obstacle_velocities is not None, soft_dist=soft_safety_distance,
            soft_w=soft_weight, iso_xy=iso_xy, last_only=last_only,
        ))
        w.append(softmax_plain(S[b], inv_temperature)[2])
        w_eps.append(weighted_noise_plain(w[b], eps[b]))
    return torch.stack(S), torch.stack(w), torch.stack(w_eps)


fleet_mppi_tick_plain.calls = 0


def launch_fleet(seeds, u, a, chol_sigma, x0, windows, stage_w, term_w, u_min, u_max, dt,
                 n_exploit, inv_temperature, obstacles, robot_radius, safety_margin_rate,
                 obstacle_velocities, soft_safety_distance, soft_weight, *, B: int, K: int,
                 T: int, W: int, last_only: bool, collision: str, iso_xy: bool):
    """Check the inputs, allocate the outputs and launch
    ``dmm_fleet_mppi_tick``. Returns ``(S, w, w_eps)``."""
    dev = u.device
    obs, n_obs = pack_obstacles(obstacles, obstacle_velocities)
    S = torch.empty((B, K), dtype=torch.float32, device=dev)
    w = torch.empty((B, K), dtype=torch.float32, device=dev)
    w_eps = torch.empty((B, T, 2), dtype=torch.float32, device=dev)
    stats = torch.empty((B, 2), dtype=torch.float32, device=dev)
    member = DmmArgs(
        seed=check_seed(seeds, dev, B),
        u=check("u", u, (B, T, 2), dev),
        a=check("a", a, (B, T, 2), dev),
        chol=check("chol_sigma", chol_sigma, (2, 2), dev),
        x0=check("x0", x0, (B, 3), dev),
        window=check("windows", windows, (B, W, 3), dev),
        stage_w=check("stage_w", stage_w, (3,), dev),
        term_w=check("term_w", term_w, (3,), dev),
        u_min=check("u_min", u_min, (2,), dev),
        u_max=check("u_max", u_max, (2,), dev),
        obstacles=check("obstacles", obs, (B, n_obs, 5), dev),
        S=S.data_ptr(), w=w.data_ptr(), w_eps=w_eps.data_ptr(), stats=stats.data_ptr(),
        K=K, T=T, W=W, n_obs=n_obs, k_blk=K, eps_mode=2, iso_xy=int(iso_xy),
        last_only=int(last_only), obs_mode=_OBS_MODES[collision],
        drift=int(obstacle_velocities is not None),
        dt=f32(dt), n_exploit=f32(n_exploit), inv_temp=f32(inv_temperature),
        obs_radius=f32(effective_robot_radius(robot_radius, safety_margin_rate)),
        soft_dist=f32(soft_safety_distance), soft_w=f32(soft_weight),
    )
    launch("dmm_fleet_mppi_tick", DmmFleetArgs(m=member, B=B), dev)
    return S, w, w_eps


def fleet_mppi_tick(
    seeds: torch.Tensor,  # (B,) int64 holding uint32 per-member seeds
    u: torch.Tensor,  # (B, T, 2) per-member nominal sequences
    a: torch.Tensor,  # (B, T, 2) per-member γ·uᵀΣ⁻¹
    chol_sigma: torch.Tensor,  # (2, 2) shared lower Cholesky factor of Σ
    x0: torch.Tensor,  # (B, 3) per-member states
    windows: torch.Tensor,  # (B, W, 3) per-member waypoint windows
    stage_w: torch.Tensor,  # (3,) shared
    term_w: torch.Tensor,
    u_min: torch.Tensor,
    u_max: torch.Tensor,
    dt: float,
    n_exploit: float,  # per-member exploration split over K
    inv_temperature: float,
    obstacles: Optional[torch.Tensor] = None,  # (B, n_obs, 2|3) per member
    robot_radius: float = 0.5,  # physical radius; the margin is applied here
    safety_margin_rate: float = 1.5,
    obstacle_velocities: Optional[torch.Tensor] = None,  # (B, n_obs, 2)
    soft_safety_distance: float = 2.0,
    soft_weight: float = 100.0,
    *,
    B: int,
    K: int,  # samples per member
    T: int,
    W: int,
    last_only: bool = False,
    collision: str = "circle",
    iso_xy: bool = False,
):
    """B independent MPPI ticks in one call. Member b draws its ε from
    ``seeds[b]`` (one block of K: the stream of
    ``diffdrive_mppi_tick_blocked(seed=seeds[b], K_BLK=K)``) and rolls out
    over its own u, a, x0, window and obstacles. Returns
    ``(S (B, K), w (B, K), w_eps (B, T, 2))``."""
    if K % 128:
        raise ValueError(f"the fleet's hash ε needs K a multiple of 128, got K={K}")
    if collision not in _OBS_MODES:
        raise ValueError(f"collision must be 'circle' or 'soft', got {collision!r}")
    if not on_cuda(u, seeds=seeds, x0=x0, windows=windows, obstacles=obstacles):
        return fleet_mppi_tick_plain(
            seeds, u, a, chol_sigma, x0, windows, stage_w, term_w, u_min, u_max, dt,
            n_exploit, inv_temperature, obstacles, robot_radius, safety_margin_rate,
            obstacle_velocities, soft_safety_distance, soft_weight, B=B, K=K, T=T, W=W,
            last_only=last_only, collision=collision, iso_xy=iso_xy,
        )
    S, w, w_eps = launch_fleet(
        seeds, u, a, chol_sigma, x0, windows, stage_w, term_w, u_min, u_max, dt, n_exploit,
        inv_temperature, obstacles, robot_radius, safety_margin_rate, obstacle_velocities,
        soft_safety_distance, soft_weight, B=B, K=K, T=T, W=W, last_only=last_only,
        collision=collision, iso_xy=iso_xy)
    fleet_mppi_tick.launches += 1
    return S, w, w_eps


fleet_mppi_tick.launches = 0

__all__ = [
    "diffdrive_mppi_tick_blocked",
    "diffdrive_mppi_tick_blocked_plain",
    "fleet_mppi_tick",
    "fleet_mppi_tick_plain",
    "weighted_noise_reduce",
    "weighted_noise_reduce_plain",
]
