"""Fused diff-drive MPPI tick: ε, rollout, softmax, Σw·ε and the epilogue.

Counterpart of ``dnn_mppi_mpc_tpu/ops/pallas/mppi_tick.py:733
diffdrive_mppi_tick`` (with ``:155 fused_epilogue_block``, ``:124
effective_robot_radius`` and ``:134 pack_obstacles``). On CUDA tensors
:func:`diffdrive_mppi_tick` launches ``dmm_mppi_tick``
(csrc/mppi_kernels.cu: the rollout with G lanes a sample, then the chunked
softmax statistics, Σw·ε, and the chunk sum with the epilogue); on CPU
tensors it runs :func:`diffdrive_mppi_tick_plain`.

Noise: ε is injected (K, T, 2), or drawn from the hash stream of
``ops/cuda/mathx.py`` as one block of K samples — the same stream as the
K-blocked tick with ``K_BLK = K`` and as the JAX blocked kernel with
``gaussian="hash"``.

``rollout_carry`` (waypoint_carry="rollout", JAX ``mppi_tick.py:493-527,
594-650``): ``window`` is the carry window gathered from the tick anchor,
each sample carries its own window start from row 0 and searches
``carry_W`` rows from it at each step, and the tick also returns the
furthest final start over K (a row of the window, a 0-d int32 tensor). Drawn ε is stored only when ``emit_eps`` asks for it;
otherwise Σw·ε draws it again (the same bits, summed in the same order, so
both give the same results). The TPU's hardware Gaussians have no
counterpart here.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..._build import DmmArgs, launch, load_kernels
from ..filters import matmul_f32
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

_OBS_MODES = {"circle": 0, "soft": 1}


def effective_robot_radius(robot_radius, safety_margin_rate):
    """The circle-collision radius: the robot radius inflated by the safety
    margin (0.5 × 1.5 = 0.75 by default)."""
    return robot_radius * safety_margin_rate


def pack_obstacles(obstacles, obstacle_velocities):
    """(..., n, 2|3) circles (+ optional (..., n, 2) velocities; a fleet has
    a leading member axis) → ((..., n, 5) rows (x, y, r, vx, vy), n);
    ``(None, 0)`` without obstacles."""
    if obstacles is None:
        return None, 0
    ob = obstacles.to(torch.float32)
    if ob.shape[-1] == 2:
        ob = torch.cat([ob, torch.zeros(ob.shape[:-1] + (1,), dtype=torch.float32,
                                        device=ob.device)], -1)
    vel = (
        obstacle_velocities[..., :2].to(torch.float32)
        if obstacle_velocities is not None
        else torch.zeros(ob.shape[:-1] + (2,), dtype=torch.float32, device=ob.device)
    )
    return torch.cat([ob[..., :3], vel], dim=-1).contiguous(), ob.shape[-2]


def fused_epilogue_plain(w_eps, filter_t, u):
    """u_new = u + F·w_eps in full f32, non-finite hold, horizon shift.
    Returns (u_new, u_shift, finite) with finite a float32 0-d tensor."""
    un = u + matmul_f32(filter_t.T, w_eps)
    finite = torch.isfinite(un).all()
    un = torch.where(finite, un, u)
    u_shift = torch.cat([un[1:], un[-1:]], dim=0)
    return un, u_shift, finite.to(torch.float32)


def diffdrive_mppi_tick_plain(
    seed, u, a, chol_sigma, x0, window, stage_w, term_w, u_min, u_max, dt,
    n_exploit, inv_temperature, obstacles=None, robot_radius=0.5,
    safety_margin_rate=1.5, eps=None, obstacle_velocities=None,
    soft_safety_distance=2.0, soft_weight=100.0, filter_t=None,
    control_weight=None, *, K: int, T: int, W: int, last_only: bool = False,
    collision: str = "circle", fuse_epilogue: bool = False, iso_xy: bool = False,
    emit_eps: bool = False, rollout_carry: bool = False, carry_W: int = 0,
):
    """Plain PyTorch version of :func:`diffdrive_mppi_tick`."""
    diffdrive_mppi_tick_plain.calls += 1
    _check_carry(rollout_carry, carry_W, W)
    if eps is None:
        eps = hash_noise(seed, chol_sigma, K, T, K)
    obs, _ = pack_obstacles(obstacles, obstacle_velocities)
    S = rollout_body_plain(
        eps, u, a, x0, window, stage_w, term_w, u_min, u_max,
        dt=dt, n_exploit=n_exploit, obstacles=obs, obs_mode=collision,
        obs_radius=effective_robot_radius(robot_radius, safety_margin_rate),
        drift=obstacle_velocities is not None, soft_dist=soft_safety_distance,
        soft_w=soft_weight, control_w=control_weight, iso_xy=iso_xy,
        last_only=last_only, carry_W=carry_W if rollout_carry else 0,
    )
    if rollout_carry:
        S, carried = S
    _, _, w = softmax_plain(S, inv_temperature)
    w_eps = weighted_noise_plain(w, eps)
    out = [S, w, w_eps]
    if fuse_epilogue:
        out.append(fused_epilogue_plain(w_eps, filter_t, u))
    if emit_eps:
        out.append(eps)
    if rollout_carry:
        out.append(carried.max().to(torch.int32))
    return tuple(out)


def _check_carry(rollout_carry: bool, carry_W: int, W: int) -> None:
    if rollout_carry and not 0 < carry_W <= W:
        raise ValueError(f"rollout_carry needs a search span 0 < carry_W <= W={W}, "
                         f"got carry_W={carry_W}")


diffdrive_mppi_tick_plain.calls = 0


def chunk_scratch_floats(K: int, k_blk: int, T: int) -> int:
    """The floats of scratch the chunked reductions of the fused and
    K-blocked ticks and of the weighted noise reduce need, as the library
    computes them (``dmm_chunk_scratch_floats``; the chunk layout lives in
    csrc/mppi_reductions.cuh alone)."""
    return load_kernels().dmm_chunk_scratch_floats(K, k_blk, T)


def rollout_group(samples: int) -> int:
    """The lanes a sample the diff-drive rollout runs with in a launch of
    ``samples`` samples (all members together): the library's rule."""
    return load_kernels().dmm_rollout_group(samples)


def launch_tick(
    *, seed, u, a, chol_sigma, x0, window, stage_w, term_w, u_min, u_max, dt,
    n_exploit, inv_temperature, obstacles, obstacle_velocities, robot_radius,
    safety_margin_rate, soft_safety_distance, soft_weight, control_weight,
    filter_t, eps, eps_mode, k_blk, K, T, W, last_only, collision, iso_xy,
    k_offset=0.0, block_offset=0, s_only=False, carry_W=0,
):
    """Check the inputs, allocate the outputs and scratch and launch
    ``dmm_mppi_tick``. ``eps_mode``: 0 ε injected, 1 drawn and stored, 2
    drawn (and drawn again in Σw·ε). ``carry_W`` > 0: the rollout carry
    with that search span (``wp_adv``, zeroed here before the launch, is
    the (1,) int32 furthest carried row). Returns a dict of the output
    tensors (``eps`` is the (T, K, 2) buffer, None when ε is drawn again;
    with ``s_only`` only S is written)."""
    if collision not in _OBS_MODES:
        raise ValueError(f"collision must be 'circle' or 'soft', got {collision!r}")
    dev = u.device
    obs, n_obs = pack_obstacles(obstacles, obstacle_velocities)
    out = dict(
        S=torch.empty(K, dtype=torch.float32, device=dev),
        w=torch.empty(K, dtype=torch.float32, device=dev),
        w_eps=torch.empty((T, 2), dtype=torch.float32, device=dev),
        stats=torch.empty(2, dtype=torch.float32, device=dev),
    )
    if eps_mode == 0:
        check("eps", eps, (K, T, 2), dev)
        out["eps"] = eps.transpose(0, 1).contiguous()  # (T, K, 2)
    elif eps_mode == 1:
        out["eps"] = torch.empty((T, K, 2), dtype=torch.float32, device=dev)
    else:
        out["eps"] = None
    fields = dict(
        u=check("u", u, (T, 2), dev),
        a=check("a", a, (T, 2), dev),
        chol=check("chol_sigma", chol_sigma, (2, 2), dev),
        x0=check("x0", x0, (3,), dev),
        window=check("window", window, (W, 3), dev),
        stage_w=check("stage_w", stage_w, (3,), dev),
        term_w=check("term_w", term_w, (3,), dev),
        u_min=check("u_min", u_min, (2,), dev),
        u_max=check("u_max", u_max, (2,), dev),
        obstacles=check("obstacles", obs, (n_obs, 5), dev),
        control_w=check("control_weight", control_weight, (2,), dev),
        filter_t=check("filter_t", filter_t, (T, T), dev),
        eps=0 if out["eps"] is None else out["eps"].data_ptr(),
        S=out["S"].data_ptr(),
        w=out["w"].data_ptr(),
        w_eps=out["w_eps"].data_ptr(),
        stats=out["stats"].data_ptr(),
        K=K, T=T, W=W, n_obs=n_obs, k_blk=k_blk, eps_mode=eps_mode,
        iso_xy=int(iso_xy), last_only=int(last_only), obs_mode=_OBS_MODES[collision],
        drift=int(obstacle_velocities is not None), fuse_epilogue=int(filter_t is not None),
        block_offset=block_offset, s_only=int(s_only), k_offset=f32(k_offset),
        dt=f32(dt), n_exploit=f32(n_exploit), inv_temp=f32(inv_temperature),
        obs_radius=f32(effective_robot_radius(robot_radius, safety_margin_rate)),
        soft_dist=f32(soft_safety_distance), soft_w=f32(soft_weight),
    )
    if eps_mode != 0:
        fields["seed"] = check_seed(seed, dev)
    if not s_only:
        n = chunk_scratch_floats(K, k_blk, T)
        out["scratch"] = torch.empty(n, dtype=torch.float32, device=dev)
        fields.update(scratch=out["scratch"].data_ptr(), scratch_floats=n)
    if filter_t is not None:
        for name, shape in (("u_new", (T, 2)), ("u_shift", (T, 2)), ("finite", ())):
            out[name] = torch.empty(shape, dtype=torch.float32, device=dev)
            fields[name] = out[name].data_ptr()
    if carry_W:
        # zeroed on the stream (a fill kernel, which a CUDA graph captures):
        # the carried starts begin at row 0, so 0 is the maximum's floor
        out["wp_adv"] = torch.zeros(1, dtype=torch.int32, device=dev)
        fields.update(wp_adv=out["wp_adv"].data_ptr(), carry_span=carry_W)
    launch("dmm_mppi_tick", DmmArgs(**fields), dev)
    return out


def diffdrive_mppi_tick(
    seed: Optional[torch.Tensor],  # (1,) int64 holding the uint32 seed; unused with eps
    u: torch.Tensor,  # (T, 2) nominal sequence
    a: torch.Tensor,  # (T, 2) γ·u_tᵀΣ⁻¹
    chol_sigma: torch.Tensor,  # (2, 2) lower Cholesky factor of Σ
    x0: torch.Tensor,  # (3,)
    window: torch.Tensor,  # (W, 3) waypoint window
    stage_w: torch.Tensor,  # (3,)
    term_w: torch.Tensor,  # (3,)
    u_min: torch.Tensor,  # (2,)
    u_max: torch.Tensor,  # (2,)
    dt: float,
    n_exploit: float,
    inv_temperature: float,
    obstacles: Optional[torch.Tensor] = None,  # (n_obs, 2|3)
    robot_radius: float = 0.5,  # physical radius; the margin is applied here
    safety_margin_rate: float = 1.5,
    eps: Optional[torch.Tensor] = None,  # (K, T, 2) injected ε
    obstacle_velocities: Optional[torch.Tensor] = None,  # (n_obs, 2) drift
    soft_safety_distance: float = 2.0,
    soft_weight: float = 100.0,
    filter_t: Optional[torch.Tensor] = None,  # (T, T) Fᵀ for the epilogue
    control_weight: Optional[torch.Tensor] = None,  # (2,) diagonal action cost
    *,
    K: int,
    T: int,
    W: int,
    last_only: bool = False,
    collision: str = "circle",
    fuse_epilogue: bool = False,
    iso_xy: bool = False,
    emit_eps: bool = False,
    rollout_carry: bool = False,
    carry_W: int = 0,
):
    """One fused MPPI tick. Returns ``(S (K,), w (K,), w_eps (T, 2))``, then
    ``(u_new, u_shift, finite)`` when ``fuse_epilogue``, then the ε used
    (K, T, 2) when ``emit_eps``, then with ``rollout_carry`` the furthest
    carried window row over K (0-d int32; ``window`` is then the carry
    window and ``carry_W`` the per-step search span).

    ``iso_xy`` specializes the cost for symmetric x/y tracking weights
    (cost sw0·d²min + sw2·Δyaw²); the caller guarantees the symmetry."""
    if fuse_epilogue and filter_t is None:
        raise ValueError("fuse_epilogue=True requires the (T, T) filter_t matrix")
    if eps is None and K % 128:
        raise ValueError(f"generated ε needs K a multiple of 128, got K={K}")
    _check_carry(rollout_carry, carry_W, W)
    if not on_cuda(u, eps=eps, seed=seed, window=window, x0=x0, obstacles=obstacles):
        return diffdrive_mppi_tick_plain(
            seed, u, a, chol_sigma, x0, window, stage_w, term_w, u_min, u_max,
            dt, n_exploit, inv_temperature, obstacles, robot_radius,
            safety_margin_rate, eps, obstacle_velocities, soft_safety_distance,
            soft_weight, filter_t, control_weight, K=K, T=T, W=W,
            last_only=last_only, collision=collision, fuse_epilogue=fuse_epilogue,
            iso_xy=iso_xy, emit_eps=emit_eps, rollout_carry=rollout_carry, carry_W=carry_W,
        )
    out = launch_tick(
        seed=seed, u=u, a=a, chol_sigma=chol_sigma, x0=x0, window=window,
        stage_w=stage_w, term_w=term_w, u_min=u_min, u_max=u_max, dt=dt,
        n_exploit=n_exploit, inv_temperature=inv_temperature,
        obstacles=obstacles, obstacle_velocities=obstacle_velocities,
        robot_radius=robot_radius, safety_margin_rate=safety_margin_rate,
        soft_safety_distance=soft_safety_distance, soft_weight=soft_weight,
        control_weight=control_weight,
        filter_t=filter_t if fuse_epilogue else None,
        eps=eps, eps_mode=0 if eps is not None else (1 if emit_eps else 2), k_blk=K,
        K=K, T=T, W=W, last_only=last_only, collision=collision, iso_xy=iso_xy,
        carry_W=carry_W if rollout_carry else 0,
    )
    diffdrive_mppi_tick.launches += 1
    result = [out["S"], out["w"], out["w_eps"]]
    if fuse_epilogue:
        result.append((out["u_new"], out["u_shift"], out["finite"]))
    if emit_eps:
        result.append(eps if eps is not None else out["eps"].transpose(0, 1))
    if rollout_carry:
        result.append(out["wp_adv"][0])
    return tuple(result)


diffdrive_mppi_tick.launches = 0

__all__ = [
    "diffdrive_mppi_tick",
    "diffdrive_mppi_tick_plain",
    "effective_robot_radius",
    "fused_epilogue_plain",
    "launch_tick",
    "pack_obstacles",
    "rollout_group",
]
