"""Batched MPPI engine on PyTorch — counterpart of ``dnn_mppi_mpc_tpu/solvers/mppi.py``.

One control tick is sample → rollout → weight → update → shift, with the
JAX engine's semantics: exploration split, in-rollout clamp, stage cost +
γ·uᵀΣ⁻¹v, softmax weights with ρ = min S, weighted update over the
unclamped ε, smoothing filter, non-finite hold, receding-horizon shift.

Three ways to run a tick, chosen by :class:`MPPISolver` with the JAX
package's routing rule:

* the scan path (a Python loop over T on (K, ...) tensors) — the port's own
  oracle, fed injected ``noise`` or a ``torch.Generator``;
* ``rollout_fn``: a split CUDA rollout kernel in place of the loop
  (:func:`make_cuda_diffdrive_rollout`, or :func:`make_cuda_bicycle_rollout`
  for the race car);
* ``tick_fn``: the whole sample-space computation in one fused kernel
  pipeline (:func:`make_cuda_diffdrive_tick`, the K-blocked
  :func:`make_cuda_diffdrive_tick_blocked` at pod-scale K, or the race car's
  :func:`make_cuda_bicycle_tick`).

The tracking costs cover the diff-drive robot (circle or soft obstacles) and
the race car (wrapped yaw, the vehicle polygon against circles).

No step waits on the host: the waypoint window start, the tick seed and the
carried key stay on the device.

Not ported yet (each raises ``ValueError``, never ignored):
``waypoint_carry="rollout"``, the generic tick (``tile_dynamics``), fleets
and sharding, and the TPU-only tuning knobs (``lean``, ``fold_anchor``,
``sincos`` modes, hardware Gaussians).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..config import CostAccumulation, MPPIConfig, MPPIParams
from ..ops.costs import (
    COLLISION_PENALTY,
    circle_robot_collision,
    soft_obstacle_cost,
    vehicle_polygon_collision,
)
from ..ops.cuda.common import f32
from ..ops.filters import apply_filter, filter_matrix, matmul_f32
from ..ops.sampling import sample_noise, sigma_inverse, small_cholesky
from ..ops.waypoints import nearest_waypoint, waypoint_window

# Weyl increments of the carried key (two uint32 words) per fused tick
_KEY_WEYL = (0x9E3779B9, 0x85EBCA6B)


@dataclasses.dataclass
class MPPIState:
    """Per-controller carry: nominal sequence, waypoint window start, key."""

    u_prev: torch.Tensor  # (T, dim_u) float32
    waypoint_idx: torch.Tensor  # () int64
    key: torch.Tensor  # (2,) int64 holding two uint32 words

    @classmethod
    def init(cls, cfg: MPPIConfig, key=None, device="cpu") -> "MPPIState":
        key = torch.zeros(2, dtype=torch.int64) if key is None else key
        return cls(
            u_prev=torch.zeros((cfg.horizon, cfg.dim_u), dtype=torch.float32, device=device),
            waypoint_idx=torch.zeros((), dtype=torch.int64, device=device),
            key=torch.as_tensor(key, dtype=torch.int64).to(device),
        )


def state_from_numpy(u_prev, waypoint_idx, key, *, device="cpu") -> MPPIState:
    """:class:`MPPIState` on ``device`` from the JAX package's ``MPPIState``
    leaves as numpy arrays (``key`` the raw (2,) uint32 key data)."""
    return MPPIState(
        u_prev=torch.tensor(np.asarray(u_prev, np.float32), device=device),
        waypoint_idx=torch.as_tensor(np.asarray(waypoint_idx, np.int64), device=device),
        key=torch.as_tensor(np.asarray(key, np.uint32).astype(np.int64), device=device),
    )


def tick_seed(key: torch.Tensor) -> torch.Tensor:
    """The fused tick's seed, w0 ^ w1 of the carried key, as a (1,) int64
    device tensor (the kernel reads it through a pointer)."""
    return (key[0] ^ key[1]).reshape(1)


def advance_key(key: torch.Tensor) -> torch.Tensor:
    """Next carried key: each word plus its Weyl increment, mod 2³² (scalar
    adds on the device: no host→device copy, so no stream sync)."""
    return torch.stack([key[0] + _KEY_WEYL[0], key[1] + _KEY_WEYL[1]]) & 0xFFFFFFFF


class CostContext(NamedTuple):
    """Tick-level context threaded to the stage/terminal costs."""

    params: MPPIParams
    waypoint_start: torch.Tensor  # () int64 window start of this tick


StageCost = Callable[[torch.Tensor, int, CostContext], torch.Tensor]
TerminalCost = Callable[[torch.Tensor, CostContext], torch.Tensor]


class MPPIAux(NamedTuple):
    """Diagnostics of one tick."""

    costs: torch.Tensor  # (K,) sample costs S
    weights: torch.Tensor  # (K,) softmax weights
    optimal_traj: torch.Tensor  # (T, dim_x) rollout of the updated sequence
    waypoint_idx: torch.Tensor  # () int64 window start after the update
    status: torch.Tensor  # () int64: 1 = end of path, 2 = non-finite (held)


def make_tracking_costs(
    cfg: MPPIConfig,
    *,
    wrap_yaw: bool = False,
    collision: str = "none",
    robot_radius: float = 0.5,
    vehicle_length: float = 4.0,
    vehicle_width: float = 3.0,
    safety_margin_rate: float = 1.5,
    soft_safety_distance: float = 2.0,
    soft_weight: float = 100.0,
) -> Tuple[StageCost, TerminalCost]:
    """Waypoint-tracking stage/terminal costs, with ``collision`` 'none',
    'circle' (+1e7 when the robot circle, radius × margin, overlaps an
    obstacle), 'polygon' (+1e7 when a point of the vehicle outline, length ×
    width × margin, lies in an obstacle) or 'soft' (exponential penalty).
    ``wrap_yaw`` wraps the yaw to [0, 2π) before differencing (race car)."""
    if collision not in ("none", "circle", "polygon", "soft"):
        raise ValueError(
            f"unknown collision mode {collision!r} (have 'none', 'circle', 'polygon', 'soft')"
        )

    def tracking(x, weight, ctx):
        _, ref = nearest_waypoint(
            ctx.params.ref_path, x[..., :2], ctx.waypoint_start, cfg.waypoint_search_len
        )
        n = weight.shape[-1]
        err = x[..., :n] - ref[..., :n]
        if wrap_yaw:
            yaw = torch.remainder(x[..., 2] + 2.0 * np.pi, 2.0 * np.pi)
            err = torch.cat([err[..., :2], (yaw - ref[..., 2])[..., None], err[..., 3:]], -1)
        return (weight * err * err).sum(-1)

    def collision_cost(x, ctx, t=None):
        obs = ctx.params.obstacles
        if collision == "none" or obs is None:
            return torch.zeros(x.shape[:-1], dtype=x.dtype, device=x.device)
        if ctx.params.obstacle_velocities is not None and t is not None:
            # drift from rollout start: initial + velocity·(t·dt); the
            # terminal cost (t None) uses the initial positions
            t_f = float(np.float32(t) * np.float32(cfg.dt))
            obs = torch.cat(
                [obs[:, :2] + ctx.params.obstacle_velocities[:, :2] * t_f, obs[:, 2:]], 1
            )
        if collision == "circle":
            return circle_robot_collision(
                x[..., :2], obs, robot_radius * safety_margin_rate
            ) * COLLISION_PENALTY
        if collision == "polygon":
            return vehicle_polygon_collision(
                x, obs, vehicle_length, vehicle_width, safety_margin_rate
            ) * COLLISION_PENALTY
        return soft_obstacle_cost(x[..., :2], obs, soft_safety_distance, soft_weight)

    def stage(x, t, ctx):
        return tracking(x, ctx.params.stage_weight, ctx) + collision_cost(x, ctx, t)

    def terminal(x, ctx):
        return tracking(x, ctx.params.terminal_weight, ctx) + collision_cost(x, ctx)

    return stage, terminal


def _time_indexed(cfg, dynamics_step):
    """Uniform F(x, u, t) view of the discrete transition."""
    if cfg.time_varying_dynamics:
        return dynamics_step
    return lambda x, v, t: dynamics_step(x, v)


def _check_tick_carry(cfg: MPPIConfig) -> None:
    if cfg.waypoint_carry != "tick":
        raise ValueError(
            f"waypoint_carry={cfg.waypoint_carry!r} is not ported yet: only "
            "'tick' (one waypoint window per control tick)"
        )


def mppi_step(
    cfg: MPPIConfig,
    dynamics_step: Callable,
    stage_cost: StageCost,
    terminal_cost: TerminalCost,
    params: MPPIParams,
    state: MPPIState,
    x0: torch.Tensor,
    noise: Optional[torch.Tensor] = None,
    rollout_fn: Optional[Callable] = None,
    tick_fn: Optional[Callable] = None,
    generator: Optional[torch.Generator] = None,
) -> Tuple[torch.Tensor, MPPIState, MPPIAux]:
    """One MPPI control tick; returns (u0, next state, aux).

    ``noise`` (K, T, dim_u) injects ε; otherwise the scan and split paths
    draw it from ``generator`` and a ``tick_fn`` draws it from the hash
    stream seeded by the carried key. ``rollout_fn(params, ctx, u, eps, x0)
    -> S`` replaces the scan loop; ``tick_fn(params, ctx, u, x0, seed, eps)``
    replaces the whole sample-space computation."""
    _check_tick_carry(cfg)
    K, T = cfg.num_samples, cfg.horizon
    u = state.u_prev
    x0 = x0.to(u.dtype)
    wp_idx, _ = nearest_waypoint(
        params.ref_path, x0[:2], state.waypoint_idx, cfg.waypoint_search_len
    )
    ctx = CostContext(params=params, waypoint_start=wp_idx)
    if params.control_weight is not None and (
        rollout_fn is not None
        or (tick_fn is not None and not getattr(tick_fn, "supports_control_cost", False))
    ):
        raise ValueError(
            "params.control_weight is implemented in the scan path and the "
            "single-block fused tick — this rollout_fn/tick_fn does not support it"
        )
    key = advance_key(state.key)

    if tick_fn is not None:
        out = tick_fn(params, ctx, u, x0, tick_seed(state.key), noise)
        if getattr(tick_fn, "fused_epilogue", False):
            S, w, _, (u_new, u_shift, finite) = out
            return _mppi_tail_fused(
                cfg, dynamics_step, params, x0, key, wp_idx, S, w, u_new, u_shift, finite
            )
        S, w, w_eps = out
        return _mppi_tail(cfg, dynamics_step, params, x0, u, key, wp_idx, S, w, w_eps)

    if noise is None:
        if generator is None:
            raise ValueError("the scan path needs injected noise or a torch.Generator")
        eps = sample_noise(generator, params.sigma, K, T, dtype=u.dtype)
    else:
        eps = noise.to(u.dtype)

    if rollout_fn is not None:
        S = rollout_fn(params, ctx, u, eps, x0)
    else:
        S = _scan_rollout(cfg, dynamics_step, stage_cost, terminal_cost, params, ctx, u, eps, x0)

    inv_temp = f32(cfg.inv_temperature)
    rho = S.min()
    m = torch.exp(-inv_temp * (S - rho))
    w = m / m.sum()
    w_eps = (w[:, None, None] * eps).sum(0)  # over the unclamped ε
    return _mppi_tail(cfg, dynamics_step, params, x0, u, key, wp_idx, S, w, w_eps)


def _scan_rollout(cfg, dynamics_step, stage_cost, terminal_cost, params, ctx, u, eps, x0):
    """Per-sample costs S (K,) of the plain rollout loop over T."""
    K, T = cfg.num_samples, cfg.horizon
    k_idx = torch.arange(K, dtype=torch.float32, device=u.device)
    exploit = (k_idx < f32((1.0 - cfg.exploration) * K))[:, None, None]
    v = torch.where(exploit, u[None] + eps, eps)
    v = torch.clamp(v, params.u_min, params.u_max)  # the clamp also feeds the energy
    a = matmul_f32(u, sigma_inverse(params.sigma))  # (T, nu): u_tᵀΣ⁻¹
    energy = cfg.gamma * (v * a).sum(-1)  # (K, T) γ·u_tᵀΣ⁻¹v_{k,t}

    # M-repeat rollouts: the same actions M times (stochastic dynamics), cost
    # averaged over M plus a discounted rollout-variance penalty
    M = max(1, cfg.num_rollout_repeats)
    batch = (K,) if M == 1 else (M, K)
    dyn_t = _time_indexed(cfg, dynamics_step)
    x = x0.expand(batch + x0.shape)
    s = torch.zeros(batch, dtype=u.dtype, device=u.device)
    var = torch.zeros(K, dtype=u.dtype, device=u.device)
    for t in range(T):
        v_t = v[:, t] if M == 1 else v[:, t].expand((M,) + v[:, t].shape)
        x = dyn_t(x, v_t, t)
        c = stage_cost(x, t, ctx) + energy[:, t]
        if params.control_weight is not None:
            c = c + (params.control_weight * v_t * v_t).sum(-1)
        if M > 1:
            disc = np.float32(cfg.rollout_var_discount) ** np.float32(t)
            var = var + c.var(0, unbiased=False) * float(disc)
        s = s + c if cfg.accumulation == CostAccumulation.SUM else c
    S = s + terminal_cost(x, ctx)
    if M > 1:
        S = S.mean(0) + cfg.rollout_var_cost * var
    return S


def _optimal_traj(cfg, dynamics_step, params, x0, u_new):
    if not cfg.compute_optimal_traj:
        return torch.zeros((cfg.horizon,) + x0.shape, dtype=u_new.dtype, device=u_new.device)
    dyn_t = _time_indexed(cfg, dynamics_step)
    xs, x = [], x0
    for t in range(cfg.horizon):
        x = dyn_t(x, torch.clamp(u_new[t], params.u_min, params.u_max), t)
        xs.append(x)
    return torch.stack(xs)


def _status(params, wp_idx, finite):
    end_of_path = (wp_idx >= params.ref_path.shape[0] - 1).to(torch.int64)
    return end_of_path + 2 * torch.logical_not(finite).to(torch.int64)


def _mppi_tail(cfg, dynamics_step, params, x0, u, key, wp_idx, S, w, w_eps):
    """Tick tail: smoothing, update, non-finite hold, shift, diagnostics."""
    w_eps = apply_filter(w_eps, cfg.filter, cfg.filter_window, cfg.savgol_polyorder)
    u_new = u + w_eps
    optimal_traj = _optimal_traj(cfg, dynamics_step, params, x0, u_new)
    finite = torch.isfinite(u_new).all()
    u_new = torch.where(finite, u_new, u)
    u_shift = torch.cat([u_new[1:], u_new[-1:]], dim=0)
    aux = MPPIAux(S, w, optimal_traj, wp_idx, _status(params, wp_idx, finite))
    return u_new[0], MPPIState(u_prev=u_shift, waypoint_idx=wp_idx, key=key), aux


def _mppi_tail_fused(cfg, dynamics_step, params, x0, key, wp_idx, S, w, u_new, u_shift, finite):
    """Tick tail when the kernel already filtered, updated, held and shifted."""
    optimal_traj = _optimal_traj(cfg, dynamics_step, params, x0, u_new)
    aux = MPPIAux(S, w, optimal_traj, wp_idx, _status(params, wp_idx, finite >= 0.5))
    return u_new[0], MPPIState(u_prev=u_shift, waypoint_idx=wp_idx, key=key), aux


def _tick_window(cfg, params, ctx, columns: int):
    """The first ``columns`` columns of this tick's window rows, contiguous,
    and W (the diff-drive kernels read (x, y, yaw), the bicycle's also v)."""
    _, window = waypoint_window(params.ref_path, ctx.waypoint_start, cfg.waypoint_search_len)
    return window[:, :columns].contiguous(), window.shape[0]


def _energy_rows(cfg, params, u):
    """a = γ·uΣ⁻¹ (T, 2), the energy-term coefficients."""
    return (cfg.gamma * matmul_f32(u, sigma_inverse(params.sigma))).contiguous()


def _reject_unported(sincos="native", gaussian="hash", fold_anchor=None, lean=None):
    """The JAX package's TPU-measurement knobs have no counterpart here."""
    if sincos != "native":
        raise ValueError(f"sincos={sincos!r} is a TPU-only mode; the kernels use sincosf")
    if gaussian != "hash":
        raise ValueError(
            f"gaussian={gaussian!r} is a TPU hardware generator; the port draws "
            "from the hash stream (gaussian='hash')"
        )
    if fold_anchor:
        raise ValueError("fold_anchor is a TPU-only tuning mode and is not ported")
    if lean:
        raise ValueError("lean is a TPU-only tuning mode and is not ported")


def _reject_repeats(cfg, what):
    if cfg.num_rollout_repeats > 1:
        raise ValueError(
            f"the {what} does not implement num_rollout_repeats>1 "
            "(M-repeat variance cost) — use the scan path"
        )


def _check_kernel_collision(collision: str) -> None:
    """The diff-drive ticks compile in the circle and soft obstacle costs."""
    if collision not in ("circle", "soft"):
        raise ValueError(
            f"the diff-drive ticks take collision 'circle' or 'soft', got {collision!r} "
            "(the vehicle polygon is the race car's: make_cuda_bicycle_tick)"
        )


def _reject_last(cfg, what):
    if cfg.accumulation == CostAccumulation.LAST:
        raise ValueError(
            f"the {what} implements SUM accumulation only — accumulation=LAST "
            "needs the scan path"
        )


def _check_iso_weights(params: MPPIParams) -> None:
    """iso_xy needs symmetric x/y tracking weights (one host read)."""
    for wgt in (params.stage_weight, params.terminal_weight):
        w0, w1 = (float(v) for v in wgt[:2].cpu())
        if w0 != w1:
            raise ValueError(
                f"iso_xy=True requires symmetric x/y weights, got ({w0}, {w1}) "
                "— drop iso_xy or symmetrize"
            )


def make_cuda_diffdrive_rollout(
    cfg: MPPIConfig, robot_radius: float = 0.5, safety_margin_rate: float = 1.5
):
    """Bind the split rollout kernel (ops/cuda/rollout.py) as ``rollout_fn``."""
    from ..ops.cuda.rollout import diffdrive_rollout_costs

    _check_tick_carry(cfg)
    _reject_repeats(cfg, "split rollout kernel")

    def rollout(params, ctx, u, eps, x0):
        if params.obstacle_velocities is not None:
            raise ValueError(
                "the split rollout kernel does not implement moving obstacles "
                "(obstacle_velocities) — use the scan path or the fused tick"
            )
        window, W = _tick_window(cfg, params, ctx, 3)
        return diffdrive_rollout_costs(
            eps.contiguous(), u, _energy_rows(cfg, params, u), x0, window,
            params.stage_weight, params.terminal_weight, params.u_min, params.u_max,
            cfg.dt, (1.0 - cfg.exploration) * cfg.num_samples,
            obstacles=params.obstacles, robot_radius=robot_radius,
            safety_margin_rate=safety_margin_rate, T=cfg.horizon, W=W,
            last_only=cfg.accumulation == CostAccumulation.LAST,
        )

    return rollout


def make_cuda_diffdrive_tick(
    cfg: MPPIConfig,
    robot_radius: float = 0.5,
    gaussian: str = "hash",
    collision: str = "circle",
    soft_safety_distance: float = 2.0,
    soft_weight: float = 100.0,
    fuse_epilogue: bool = False,
    iso_xy: bool = False,
    sincos: str = "native",
    fold_anchor: Optional[bool] = None,
    safety_margin_rate: float = 1.5,
    lean: Optional[bool] = None,
):
    """Bind the fused tick (ops/cuda/mppi_tick.py) as ``tick_fn``.

    ``collision`` must match the bound cost functions ('circle' or 'soft';
    obstacles may drift). ``iso_xy`` specializes for symmetric x/y weights
    (the solver checks them once per params object). With
    ``fuse_epilogue`` the kernel also applies the filter, update,
    non-finite hold and shift."""
    from ..ops.cuda.mppi_tick import diffdrive_mppi_tick

    _check_tick_carry(cfg)
    _reject_unported(sincos=sincos, gaussian=gaussian, fold_anchor=fold_anchor, lean=lean)
    _reject_repeats(cfg, "fused tick")
    _check_kernel_collision(collision)
    filter_np = np.ascontiguousarray(
        filter_matrix(cfg.filter.value, cfg.horizon, cfg.filter_window, cfg.savgol_polyorder).T,
        np.float32,
    )
    filter_t = {}  # device → Fᵀ tensor, made once per device

    def tick(params, ctx, u, x0, seed, noise):
        window, W = _tick_window(cfg, params, ctx, 3)
        ft = None
        if fuse_epilogue:
            if u.device not in filter_t:
                filter_t[u.device] = torch.as_tensor(filter_np, device=u.device)
            ft = filter_t[u.device]
        return diffdrive_mppi_tick(
            seed, u, _energy_rows(cfg, params, u), small_cholesky(params.sigma),
            x0, window, params.stage_weight, params.terminal_weight,
            params.u_min, params.u_max, cfg.dt,
            (1.0 - cfg.exploration) * cfg.num_samples, cfg.inv_temperature,
            obstacles=params.obstacles, robot_radius=robot_radius,
            safety_margin_rate=safety_margin_rate,
            eps=None if noise is None else noise.contiguous(),
            obstacle_velocities=params.obstacle_velocities,
            soft_safety_distance=soft_safety_distance, soft_weight=soft_weight,
            filter_t=ft, control_weight=params.control_weight,
            K=cfg.num_samples, T=cfg.horizon, W=W,
            last_only=cfg.accumulation == CostAccumulation.LAST,
            collision=collision, fuse_epilogue=fuse_epilogue, iso_xy=iso_xy,
        )

    tick.fused_epilogue = fuse_epilogue
    tick.supports_control_cost = True
    tick.iso_xy = iso_xy
    return tick


def make_cuda_diffdrive_tick_blocked(
    cfg: MPPIConfig,
    robot_radius: float = 0.5,
    k_block: int = 10240,
    collision: str = "circle",
    soft_safety_distance: float = 2.0,
    soft_weight: float = 100.0,
    iso_xy: bool = False,
    sincos: str = "native",
    safety_margin_rate: float = 1.5,
):
    """Bind the K-blocked tick (ops/cuda/mppi_tick_blocked.py) as ``tick_fn``
    — pod-scale K, hash-stream ε only (injected noise raises)."""
    from ..ops.cuda.mppi_tick_blocked import diffdrive_mppi_tick_blocked

    _check_tick_carry(cfg)
    _reject_unported(sincos=sincos)
    _reject_repeats(cfg, "blocked fused tick")
    _check_kernel_collision(collision)
    if cfg.num_samples % k_block != 0:
        raise ValueError(
            f"num_samples={cfg.num_samples} must be a multiple of k_block={k_block}"
        )

    def tick(params, ctx, u, x0, seed, noise):
        if noise is not None:
            raise ValueError(
                "the blocked fused tick is PRNG-mode only (per-block hash ε) — "
                "use the single-block tick or scan path for injected noise"
            )
        window, W = _tick_window(cfg, params, ctx, 3)
        S, rho, eta, w_eps = diffdrive_mppi_tick_blocked(
            seed, u, _energy_rows(cfg, params, u), small_cholesky(params.sigma),
            x0, window, params.stage_weight, params.terminal_weight,
            params.u_min, params.u_max, cfg.dt,
            (1.0 - cfg.exploration) * cfg.num_samples, cfg.inv_temperature,
            obstacles=params.obstacles, robot_radius=robot_radius,
            safety_margin_rate=safety_margin_rate,
            obstacle_velocities=params.obstacle_velocities,
            soft_safety_distance=soft_safety_distance, soft_weight=soft_weight,
            K=cfg.num_samples, T=cfg.horizon, W=W, K_BLK=k_block,
            last_only=cfg.accumulation == CostAccumulation.LAST,
            collision=collision, iso_xy=iso_xy,
        )
        w = torch.exp(-f32(cfg.inv_temperature) * (S - rho)) / eta
        return S, w, w_eps

    tick.iso_xy = iso_xy
    return tick


def _bicycle_kernel_args(cfg, params, ctx, u, x0, vehicle, what):
    """The arguments both bicycle kernels share, for this tick."""
    if params.obstacle_velocities is not None:
        raise ValueError(
            f"the {what} does not implement moving obstacles "
            "(obstacle_velocities) — use the scan path"
        )
    window, W = _tick_window(cfg, params, ctx, 4)
    return dict(
        u=u, a=_energy_rows(cfg, params, u), x0=x0, window=window,
        stage_w=params.stage_weight, term_w=params.terminal_weight,
        u_min=params.u_min, u_max=params.u_max, dt=cfg.dt,
        n_exploit=(1.0 - cfg.exploration) * cfg.num_samples,
        obstacles=params.obstacles, T=cfg.horizon, W=W, **vehicle,
    )


def make_cuda_bicycle_rollout(
    cfg: MPPIConfig,
    wheel_base: float = 2.5,
    vehicle_length: float = 4.0,
    vehicle_width: float = 3.0,
    margin_rate: float = 1.5,
):
    """Bind the split bicycle rollout (ops/cuda/rollout_bicycle.py) as
    ``rollout_fn``: Euler kinematic bicycle, wrap-yaw 4-term tracking,
    vehicle polygon against circles, SUM only. LAST accumulation, M-repeat
    rollouts and moving obstacles raise ``ValueError``."""
    from ..ops.cuda.rollout_bicycle import bicycle_rollout_costs

    _check_tick_carry(cfg)
    _reject_last(cfg, "split bicycle rollout")
    _reject_repeats(cfg, "split bicycle rollout")
    vehicle = dict(wheel_base=wheel_base, vehicle_length=vehicle_length,
                   vehicle_width=vehicle_width, margin_rate=margin_rate)

    def rollout(params, ctx, u, eps, x0):
        args = _bicycle_kernel_args(cfg, params, ctx, u, x0, vehicle, "split bicycle rollout")
        return bicycle_rollout_costs(eps.contiguous(), **args)

    return rollout


def make_cuda_bicycle_tick(
    cfg: MPPIConfig,
    wheel_base: float = 2.5,
    vehicle_length: float = 4.0,
    vehicle_width: float = 3.0,
    margin_rate: float = 1.5,
    gaussian: str = "hash",
    iso_xy: bool = False,
    sincos: str = "native",
):
    """Bind the fused bicycle tick (ops/cuda/bicycle_tick.py) as ``tick_fn``
    — ε from the hash stream seeded by the carried key, or injected; the
    semantics of :func:`make_cuda_bicycle_rollout`. ``iso_xy`` specializes
    for symmetric x/y tracking weights (the solver checks them once per
    params object)."""
    from ..ops.cuda.bicycle_tick import bicycle_mppi_tick

    _check_tick_carry(cfg)
    _reject_unported(sincos=sincos, gaussian=gaussian)
    _reject_last(cfg, "fused bicycle tick")
    _reject_repeats(cfg, "fused bicycle tick")
    vehicle = dict(wheel_base=wheel_base, vehicle_length=vehicle_length,
                   vehicle_width=vehicle_width, margin_rate=margin_rate)

    def tick(params, ctx, u, x0, seed, noise):
        args = _bicycle_kernel_args(cfg, params, ctx, u, x0, vehicle, "fused bicycle tick")
        return bicycle_mppi_tick(
            seed, chol_sigma=small_cholesky(params.sigma),
            inv_temperature=cfg.inv_temperature,
            eps=None if noise is None else noise.contiguous(),
            K=cfg.num_samples, iso_xy=iso_xy, **args,
        )

    tick.iso_xy = iso_xy
    return tick


# The JAX package's routing rule between the single-block and the K-blocked
# tick (its TPU VMEM budget), kept so that both packages route a
# configuration to the same kernel.
_SINGLE_BLOCK_VMEM_BUDGET = 10 * 2**20
_EPS_BYTES_PER_SAMPLE_STEP = 16


def _pick_k_block(K: int, T: int) -> int:
    """Largest multiple-of-1024 divisor of K within the single-block budget."""
    best = 0
    for blk in range(1024, K + 1, 1024):
        if K % blk == 0 and _EPS_BYTES_PER_SAMPLE_STEP * T * blk <= _SINGLE_BLOCK_VMEM_BUDGET:
            best = blk
    if not best:
        raise ValueError(
            f"no multiple-of-1024 block divides K={K} within the budget at "
            f"T={T} — pick K a multiple of 1024 (e.g. 102 400)"
        )
    return best


class MPPISolver:
    """Binds config + dynamics + costs and routes each tick to a kernel.

    ``fused_tick=True`` binds the fused tick, or the K-blocked tick when
    16·T·K bytes exceed 10 MiB (the JAX package's rule); ``use_kernel``
    (default ``cfg.use_kernel``) binds the split rollout kernel otherwise.
    Tensors on ``device`` decide where each tick runs: a CUDA device
    launches the kernels, the CPU runs their plain versions.
    """

    def __init__(
        self,
        cfg: MPPIConfig,
        dynamics_step: Callable,
        stage_cost: StageCost,
        terminal_cost: TerminalCost,
        use_kernel: Optional[bool] = None,
        robot_radius: float = 0.5,
        safety_margin_rate: float = 1.5,
        rollout_fn: Optional[Callable] = None,
        fused_tick: bool = False,
        tick_fn: Optional[Callable] = None,
        gaussian: str = "hash",
        tile_dynamics: Optional[Callable] = None,
        collision: str = "circle",
        soft_safety_distance: float = 2.0,
        soft_weight: float = 100.0,
        fuse_epilogue: bool = True,
        iso_xy: bool = False,
        fold_anchor: Optional[bool] = None,
        lean: Optional[bool] = None,
        sincos: str = "native",
        device="cpu",
        seed: int = 0,
    ) -> None:
        _check_tick_carry(cfg)
        _reject_unported(sincos=sincos, gaussian=gaussian, fold_anchor=fold_anchor, lean=lean)
        if tile_dynamics is not None:
            raise ValueError("tile_dynamics (the generic fused tick) is not ported yet")
        use_kernel = cfg.use_kernel if use_kernel is None else use_kernel
        if cfg.time_varying_dynamics and (use_kernel or fused_tick) and (
            tick_fn is None and rollout_fn is None
        ):
            raise ValueError(
                "time_varying_dynamics needs the scan path: the diff-drive "
                "kernels compile their dynamics in"
            )
        self.cfg = cfg
        self.dynamics_step = dynamics_step
        self.stage_cost = stage_cost
        self.terminal_cost = terminal_cost
        self.device = torch.device(device)
        self.generator = torch.Generator(device=self.device).manual_seed(seed)
        if tick_fn is None and fused_tick:
            if _EPS_BYTES_PER_SAMPLE_STEP * cfg.horizon * cfg.num_samples > _SINGLE_BLOCK_VMEM_BUDGET:
                tick_fn = make_cuda_diffdrive_tick_blocked(
                    cfg, robot_radius, k_block=_pick_k_block(cfg.num_samples, cfg.horizon),
                    collision=collision, soft_safety_distance=soft_safety_distance,
                    soft_weight=soft_weight, iso_xy=iso_xy,
                    safety_margin_rate=safety_margin_rate,
                )
            else:
                tick_fn = make_cuda_diffdrive_tick(
                    cfg, robot_radius, collision=collision,
                    soft_safety_distance=soft_safety_distance, soft_weight=soft_weight,
                    fuse_epilogue=fuse_epilogue, iso_xy=iso_xy,
                    safety_margin_rate=safety_margin_rate,
                )
        if rollout_fn is None and use_kernel and tick_fn is None:
            rollout_fn = make_cuda_diffdrive_rollout(
                cfg, robot_radius, safety_margin_rate=safety_margin_rate
            )
        self.rollout_fn = rollout_fn
        self.tick_fn = tick_fn
        self._iso_checked: Optional[MPPIParams] = None

    def init(self, key=None) -> MPPIState:
        return MPPIState.init(self.cfg, key, device=self.device)

    def step(
        self,
        params: MPPIParams,
        state: MPPIState,
        x0: torch.Tensor,
        noise: Optional[torch.Tensor] = None,
    ) -> Tuple[torch.Tensor, MPPIState, MPPIAux]:
        if getattr(self.tick_fn, "iso_xy", False) and params is not self._iso_checked:
            _check_iso_weights(params)  # once per params object
            self._iso_checked = params
        return mppi_step(
            self.cfg, self.dynamics_step, self.stage_cost, self.terminal_cost,
            params, state, x0, noise, rollout_fn=self.rollout_fn,
            tick_fn=self.tick_fn, generator=self.generator,
        )


__all__ = [
    "CostContext",
    "MPPIAux",
    "MPPISolver",
    "MPPIState",
    "advance_key",
    "make_cuda_bicycle_rollout",
    "make_cuda_bicycle_tick",
    "make_cuda_diffdrive_rollout",
    "make_cuda_diffdrive_tick",
    "make_cuda_diffdrive_tick_blocked",
    "make_tracking_costs",
    "mppi_step",
    "state_from_numpy",
    "tick_seed",
]
