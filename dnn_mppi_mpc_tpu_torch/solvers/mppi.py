"""Batched MPPI engine on PyTorch — counterpart of ``dnn_mppi_mpc_tpu/solvers/mppi.py``.

One control tick is sample → rollout → weight → update → shift, with the
JAX engine's semantics: exploration split, in-rollout clamp, stage cost +
γ·uᵀΣ⁻¹v, softmax weights with ρ = min S, weighted update over the
unclamped ε, smoothing filter, non-finite hold, receding-horizon shift.

Three ways to run a tick of one controller, chosen by :class:`MPPISolver`
with the JAX package's routing rule:

* the scan path (a Python loop over T on (K, ...) tensors) — the port's own
  oracle, fed injected ``noise`` or a ``torch.Generator``;
* ``rollout_fn``: a split CUDA rollout kernel in place of the loop
  (:func:`make_cuda_diffdrive_rollout`, :func:`make_cuda_bicycle_rollout`
  for the race car, or :func:`make_cuda_generic_rollout` for any tile-step
  model);
* ``tick_fn``: the whole sample-space computation in one fused kernel
  pipeline (:func:`make_cuda_diffdrive_tick`, the K-blocked
  :func:`make_cuda_diffdrive_tick_blocked` at pod-scale K, the race car's
  :func:`make_cuda_bicycle_tick`, or the generic
  :func:`make_cuda_generic_tick` over a tile step of ``models/tile.py``,
  which ``MPPISolver(fused_tick=True, tile_dynamics=...)`` binds).

A fleet of B independent controllers ticks in one kernel pipeline through
:func:`make_fleet_fused_mppi_step` (batched :class:`MPPIState`, leading B);
the sample-sharded ticks and the sharded fleet are in
``parallel/sharding.py``: the scan-path one runs :func:`mppi_step` with a
process ``group``, each rank rolling out its K/n samples.

The tracking costs cover the diff-drive robot (circle or soft obstacles),
the race car (wrapped yaw, the vehicle polygon against circles) and any
tile-step model (the first n_track state dims, circle or soft obstacles).

No step waits on the host: the waypoint window start, the tick seed and the
carried key stay on the device. Entry points run on the card unless the
caller passes ``device="cpu"``.

``waypoint_carry="rollout"`` (a window start carried by each rollout) runs
on the scan path, the diff-drive fused tick and the generic tick; the split
rollouts, the K-blocked tick, the race car and the fleet raise, as in JAX.

:func:`sampled_trajectories` re-rolls a tick's samples for visualization,
best first. The vmapped scan-path fleet is ``parallel/sharding.py``'s
``make_batched_mppi_step``.

Not ported (each raises ``ValueError``, never ignored): lifted and
time-varying tile steps on the card (they run on the CPU), and the TPU-only
tuning knobs (``lean``, ``fold_anchor``, ``sincos`` modes, hardware
Gaussians).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Callable, NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..config import (
    CostAccumulation,
    MPPIConfig,
    MPPIParams,
    SmoothingFilter,
    resolve_device,
)
from ..ops.costs import (
    COLLISION_PENALTY,
    circle_robot_collision,
    soft_obstacle_cost,
    vehicle_polygon_collision,
)
from ..ops.cuda.common import f32
from ..ops.filters import apply_filter, filter_matrix, filter_tensor, matmul_f32
from ..ops.sampling import sample_noise, sigma_inverse, small_cholesky
from ..ops.waypoints import (
    fleet_nearest_waypoint,
    fleet_waypoint_windows,
    nearest_waypoint,
    nearest_waypoint_carried,
    waypoint_window,
)

# Weyl increments of the carried key (two uint32 words) per fused tick
_KEY_WEYL = (0x9E3779B9, 0x85EBCA6B)


def _key_words(key, device) -> torch.Tensor:
    """Raw uint32 key words (a tensor, or anything numpy reads) as int64 on
    ``device``."""
    if not isinstance(key, torch.Tensor):
        key = torch.from_numpy(np.asarray(key, np.uint32).astype(np.int64))
    return key.to(device=device, dtype=torch.int64)


@dataclasses.dataclass
class MPPIState:
    """Per-controller carry: nominal sequence, waypoint window start, key.
    A fleet's state carries a leading member axis B on every leaf."""

    u_prev: torch.Tensor  # (T, dim_u) float32; (B, T, dim_u) for a fleet
    waypoint_idx: torch.Tensor  # () int64; (B,)
    key: torch.Tensor  # (2,) int64 holding two uint32 words; (B, 2)

    @classmethod
    def init(cls, cfg: MPPIConfig, key=None, device="cuda") -> "MPPIState":
        device = resolve_device(device)
        key = [0, 0] if key is None else key
        return cls(
            u_prev=torch.zeros((cfg.horizon, cfg.dim_u), dtype=torch.float32, device=device),
            waypoint_idx=torch.zeros((), dtype=torch.int64, device=device),
            key=_key_words(key, device),
        )

    @classmethod
    def fleet(cls, cfg: MPPIConfig, keys, device="cuda") -> "MPPIState":
        """The initial state of B controllers from their (B, 2) raw uint32
        keys (the JAX fleet's ``vmap(MPPIState.init)`` over
        ``vmap(PRNGKey)(arange(B))`` has keys [[0, b]])."""
        device = resolve_device(device)
        keys = _key_words(keys, device)
        B = keys.shape[0]
        return cls(
            u_prev=torch.zeros((B, cfg.horizon, cfg.dim_u), dtype=torch.float32, device=device),
            waypoint_idx=torch.zeros((B,), dtype=torch.int64, device=device),
            key=keys,
        )


def state_from_numpy(u_prev, waypoint_idx, key, *, device="cuda") -> MPPIState:
    """:class:`MPPIState` on ``device`` from the JAX package's ``MPPIState``
    leaves as numpy arrays (``key`` the raw (2,) uint32 key data). Batched
    leaves — a JAX fleet's (B, T, 2), (B,) and (B, 2) — give a fleet state."""
    device = resolve_device(device)
    return MPPIState(
        u_prev=torch.tensor(np.asarray(u_prev, np.float32), device=device),
        waypoint_idx=torch.as_tensor(np.asarray(waypoint_idx, np.int64), device=device),
        key=torch.as_tensor(np.asarray(key, np.uint32).astype(np.int64), device=device),
    )


def tick_seed(key: torch.Tensor) -> torch.Tensor:
    """The fused tick's seed, w0 ^ w1 of the carried key, as a (1,) int64
    device tensor (the kernel reads it through a pointer); a fleet's (B, 2)
    keys give its (B,) seeds."""
    return (key[..., 0] ^ key[..., 1]).reshape(-1)


def advance_key(key: torch.Tensor) -> torch.Tensor:
    """Next carried key(s), (2,) or (B, 2): each word plus its Weyl
    increment, mod 2³² (scalar adds on the device: no host→device copy, so no
    stream sync)."""
    return torch.stack(
        [key[..., 0] + _KEY_WEYL[0], key[..., 1] + _KEY_WEYL[1]], dim=-1
    ) & 0xFFFFFFFF


class CostContext(NamedTuple):
    """Tick-level context threaded to the stage/terminal costs."""

    params: MPPIParams
    # () int64 window start of this tick; with waypoint_carry="rollout" the
    # per-sample carried starts
    waypoint_start: torch.Tensor
    # the nearest-waypoint rows (..., d) the carried rollout already looked
    # up for this step, which the tracking cost reuses
    waypoint_ref: Optional[torch.Tensor] = None


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
        if ctx.waypoint_ref is not None:
            ref = ctx.waypoint_ref
        elif ctx.waypoint_start.dim() > 0:  # waypoint_carry="rollout": per-sample starts
            _, ref = nearest_waypoint_carried(
                ctx.params.ref_path, x[..., :2], ctx.waypoint_start, cfg.waypoint_search_len
            )
        else:
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


def _check_carry_modes(cfg: MPPIConfig) -> None:
    if cfg.waypoint_carry not in ("tick", "rollout"):
        raise ValueError(f"waypoint_carry must be 'tick' or 'rollout': {cfg.waypoint_carry!r}")
    if cfg.waypoint_persist not in ("none", "max"):
        raise ValueError(f"waypoint_persist must be 'none' or 'max': {cfg.waypoint_persist!r}")


def _check_tick_carry(cfg: MPPIConfig, what: str) -> None:
    """``what`` anchors its waypoint window per tick: the per-rollout carry
    raises (JAX implements it only in the scan path, the single-block
    diff-drive tick and the generic tick)."""
    _check_carry_modes(cfg)
    if cfg.waypoint_carry != "tick":
        raise ValueError(
            f"waypoint_carry={cfg.waypoint_carry!r} is not implemented by the {what}: the "
            "per-rollout carry runs in the scan path, the single-block diff-drive fused "
            "tick and the generic fused tick"
        )


def carry_window_len(cfg: MPPIConfig, P: int) -> int:
    """The rows a carrying kernel gathers from the tick anchor:
    ``carry_window_len`` (default W + T), at most the path's P."""
    n = cfg.carry_window_len
    return min(cfg.waypoint_search_len + cfg.horizon if n is None else n, P)


def _carry_window(cfg, params, ctx, columns: int):
    """The carry window of a carrying kernel: the ``carry_window_len`` rows
    from the tick anchor (clipped to [0, P − 1]) with indices clamped to
    P − 1, so the path end repeats its last row (the kernels' first-tie rule
    resolves the repeats to the genuine index); the anchor, the rows and the
    per-step search span."""
    P = params.ref_path.shape[0]
    start = torch.clamp(ctx.waypoint_start, 0, P - 1)
    rows = torch.clamp(start + torch.arange(carry_window_len(cfg, P), dtype=torch.int64,
                                            device=start.device), max=P - 1)
    window = params.ref_path.index_select(0, rows)[:, :columns].contiguous()
    return start, window, min(cfg.waypoint_search_len, P)


def _carried_global(start, wp_adv, P: int) -> torch.Tensor:
    """The kernel's furthest local carried row as a global path index."""
    return torch.clamp(start + wp_adv.to(torch.int64).reshape(()), max=P - 1)


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
    group: Optional[dist.ProcessGroup] = None,
) -> Tuple[torch.Tensor, MPPIState, MPPIAux]:
    """One MPPI control tick; returns (u0, next state, aux).

    ``noise`` (K, T, dim_u) injects ε; otherwise the scan and split paths
    draw it from ``generator`` and a ``tick_fn`` draws it from the hash
    stream seeded by the carried key. ``rollout_fn(params, ctx, u, eps, x0,
    k_offset=...) -> S`` replaces the scan loop (``k_offset`` is the global
    index of its first sample, the counterpart of the ``axis_name`` JAX
    hands its rollout_fns); ``tick_fn(params, ctx, u, x0, seed, eps)``
    replaces the whole sample-space computation.

    ``group`` (a process group, the counterpart of JAX's ``axis_name``)
    shards the samples over its n ranks: rank i rolls out samples
    [i·K/n, (i+1)·K/n) — its (K/n, T, dim_u) slice of ``noise``, or ε from
    its own ``generator`` — and ρ (all-reduce MIN), η (SUM) and Σw·ε (SUM)
    are taken over all ranks; ``aux.costs`` / ``aux.weights`` are this
    rank's. Nothing changes without a group.

    ``cfg.waypoint_carry="rollout"`` carries a window start per rollout
    (scan path, or a ``tick_fn`` with ``supports_rollout_carry`` that returns
    the furthest carried index last); with ``waypoint_persist="max"`` the
    furthest index becomes the next tick's window start, while ``status``
    still judges the tick-level index."""
    _check_carry_modes(cfg)
    K, T = cfg.num_samples, cfg.horizon
    n_ranks = 1 if group is None else dist.get_world_size(group)
    local_K = K // n_ranks
    k_offset = 0.0 if group is None else float(dist.get_rank(group) * local_K)
    u = state.u_prev
    x0 = x0.to(u.dtype)
    wp_idx, _ = nearest_waypoint(
        params.ref_path, x0[:2], state.waypoint_idx, cfg.waypoint_search_len
    )
    ctx = CostContext(params=params, waypoint_start=wp_idx)
    carry = cfg.waypoint_carry == "rollout"
    if carry and rollout_fn is not None:
        raise ValueError(
            "waypoint_carry='rollout' is not supported by the sharded rollout_fn path "
            "(the per-sample carry is kernel-local) — use the fused tick or the scan path"
        )
    if params.control_weight is not None and (
        rollout_fn is not None
        or (tick_fn is not None and not getattr(tick_fn, "supports_control_cost", False))
    ):
        raise ValueError(
            "params.control_weight is implemented in the scan path and the "
            "single-block fused tick — this rollout_fn/tick_fn does not support it"
        )
    if carry and tick_fn is not None and not getattr(tick_fn, "supports_rollout_carry", False):
        raise ValueError(
            "this tick_fn anchors its waypoint window per tick — build it with a cfg whose "
            "waypoint_carry='rollout' (make_cuda_diffdrive_tick / make_cuda_generic_tick)"
        )
    key = advance_key(state.key)
    persist = carry and cfg.waypoint_persist == "max"

    if tick_fn is not None:
        if group is not None:
            raise ValueError(
                "tick_fn (a fused tick kernel) is single-device only — use rollout_fn for "
                "sample-sharded execution"
            )
        out = tick_fn(params, ctx, u, x0, tick_seed(state.key), noise)
        wp_next, status_idx = wp_idx, None
        if carry:
            *out, wp_carried = out
            if persist:
                wp_next, status_idx = wp_carried, wp_idx
        if getattr(tick_fn, "fused_epilogue", False):
            S, w, _, (u_new, u_shift, finite) = out
            return _mppi_tail_fused(
                cfg, dynamics_step, params, x0, key, wp_next, S, w, u_new, u_shift, finite,
                status_idx,
            )
        S, w, w_eps = out
        return _mppi_tail(cfg, dynamics_step, params, x0, u, key, wp_next, S, w, w_eps,
                          status_idx)

    if noise is None:
        if generator is None:
            raise ValueError("the scan path needs injected noise or a torch.Generator")
        eps = sample_noise(generator, params.sigma, local_K, T, dtype=u.dtype)
    else:
        eps = noise.to(u.dtype)
    if eps.shape[0] != local_K:
        raise ValueError(f"noise has {eps.shape[0]} samples, expected {local_K} on this rank")

    status_idx = None
    if rollout_fn is not None:
        S = rollout_fn(params, ctx, u, eps, x0, k_offset=k_offset)
    else:
        S, wpi_final = _scan_rollout(cfg, dynamics_step, stage_cost, terminal_cost, params, ctx,
                                     u, eps, x0, k_offset)
        if persist:
            # the furthest carried index becomes the next tick's window start;
            # the end-of-path status keeps judging the tick-level index
            wp_next = wpi_final.max()
            if group is not None:
                dist.all_reduce(wp_next, op=dist.ReduceOp.MAX, group=group)
            wp_idx, status_idx = wp_next, wp_idx

    inv_temp = f32(cfg.inv_temperature)
    if group is None:
        rho = S.min()
        m = torch.exp(-inv_temp * (S - rho))
        w = m / m.sum()
        w_eps = (w[:, None, None] * eps).sum(0)  # over the unclamped ε
    else:
        rho = S.min().reshape(1)
        dist.all_reduce(rho, op=dist.ReduceOp.MIN, group=group)
        m = torch.exp(-inv_temp * (S - rho))
        eta = m.sum().reshape(1)
        dist.all_reduce(eta, op=dist.ReduceOp.SUM, group=group)
        w = m / eta
        w_eps = (w[:, None, None] * eps).sum(0)
        dist.all_reduce(w_eps, op=dist.ReduceOp.SUM, group=group)
    return _mppi_tail(cfg, dynamics_step, params, x0, u, key, wp_idx, S, w, w_eps, status_idx)


def _scan_rollout(cfg, dynamics_step, stage_cost, terminal_cost, params, ctx, u, eps, x0,
                  k_offset=0.0):
    """Per-sample costs S (K_local,) of the plain rollout loop over T, for
    the samples of ``eps`` from global index ``k_offset`` on (the
    exploration split is over the global K), and with
    ``waypoint_carry="rollout"`` the final carried window starts (else
    None): each step looks up its rows from the carry before the step (the
    reference's ``_get_nearest_waypoint(update_prev_idx=True)``) and its
    argmin becomes the next carry; the terminal cost searches from the
    final carry."""
    K, T = eps.shape[0], cfg.horizon
    k_idx = torch.arange(K, dtype=torch.float32, device=u.device)
    if k_offset:
        k_idx = k_idx + f32(k_offset)
    exploit = (k_idx < f32((1.0 - cfg.exploration) * cfg.num_samples))[:, None, None]
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
    carry = cfg.waypoint_carry == "rollout"
    wpi = ctx.waypoint_start.expand(batch) if carry else None
    for t in range(T):
        v_t = v[:, t] if M == 1 else v[:, t].expand((M,) + v[:, t].shape)
        x = dyn_t(x, v_t, t)
        ctx_t = ctx
        if carry:
            idx_new, ref = nearest_waypoint_carried(
                params.ref_path, x[..., :2], wpi, cfg.waypoint_search_len
            )
            ctx_t = ctx._replace(waypoint_start=wpi, waypoint_ref=ref)
            wpi = idx_new
        c = stage_cost(x, t, ctx_t) + energy[:, t]
        if params.control_weight is not None:
            c = c + (params.control_weight * v_t * v_t).sum(-1)
        if M > 1:
            disc = np.float32(cfg.rollout_var_discount) ** np.float32(t)
            var = var + c.var(0, unbiased=False) * float(disc)
        s = s + c if cfg.accumulation == CostAccumulation.SUM else c
    S = s + terminal_cost(x, ctx._replace(waypoint_start=wpi) if carry else ctx)
    if M > 1:
        S = S.mean(0) + cfg.rollout_var_cost * var
    return S, wpi


def _optimal_traj(cfg, dynamics_step, params, x0, u_new):
    """(..., T, dim_x) rollout of the updated sequence(s) u_new (..., T, dim_u)."""
    if not cfg.compute_optimal_traj:
        return torch.zeros(x0.shape[:-1] + (cfg.horizon, x0.shape[-1]), dtype=u_new.dtype,
                           device=u_new.device)
    dyn_t = _time_indexed(cfg, dynamics_step)
    xs, x = [], x0
    for t in range(cfg.horizon):
        x = dyn_t(x, torch.clamp(u_new[..., t, :], params.u_min, params.u_max), t)
        xs.append(x)
    return torch.stack(xs, dim=-2)


def sampled_trajectories(
    cfg: MPPIConfig,
    dynamics_step: Callable,
    params: MPPIParams,
    state: MPPIState,
    x0: torch.Tensor,
    noise: torch.Tensor,
    costs: torch.Tensor,
    top_fraction: float = 1.0,
) -> torch.Tensor:
    """Re-roll the sampled sequences for visualization, cost-sorted (best
    first): the (n_top, T, dim_x) states of the ``n_top = max(1, ⌊K ·
    top_fraction⌋)`` samples of least ``costs`` (K,), from the tick's ε
    ``noise`` (K, T, dim_u) and the nominal sequence of ``state`` (the
    state the tick started from). Ties keep the sample order (a stable
    sort, as JAX's ``argsort``). Separate from the tick so that the (K, T,
    dim_x) tensor exists only on demand; nothing in it waits for the card."""
    K = cfg.num_samples
    u = state.u_prev
    x0 = x0.to(u.dtype)
    k_idx = torch.arange(K, dtype=torch.float32, device=u.device)
    exploit = (k_idx < f32((1.0 - cfg.exploration) * K))[:, None, None]
    v = torch.clamp(torch.where(exploit, u[None] + noise, noise), params.u_min, params.u_max)
    dyn_t = _time_indexed(cfg, dynamics_step)
    x, xs = x0.expand((K,) + x0.shape), []
    for t in range(cfg.horizon):
        x = dyn_t(x, v[:, t], t)
        xs.append(x)
    trajs = torch.stack(xs, dim=1)  # (K, T, dim_x)
    order = torch.argsort(costs, stable=True)
    n_top = max(1, int(K * top_fraction))
    return trajs.index_select(0, order[:n_top])


def _status(params, wp_idx, finite):
    # with a persisted lookahead carry the caller passes the tick-level index
    # a fleet's per-member (B, P, d) path: member 0's length P, as the JAX
    # fleet tail reads it
    end_of_path = (wp_idx >= params.ref_path.shape[-2] - 1).to(torch.int64)
    return end_of_path + 2 * torch.logical_not(finite).to(torch.int64)


def _mppi_tail(cfg, dynamics_step, params, x0, u, key, wp_idx, S, w, w_eps, status_idx=None):
    """Tick tail: smoothing, update, non-finite hold, shift, diagnostics —
    for one controller, or written over a fleet's leading member axis (each
    member held on its own non-finite update). ``status_idx`` (default
    ``wp_idx``) is the index the end-of-path flag judges: a persisted
    lookahead ``wp_idx`` reaches the path end ticks before the robot."""
    w_eps = apply_filter(w_eps, cfg.filter, cfg.filter_window, cfg.savgol_polyorder)
    u_new = u + w_eps
    optimal_traj = _optimal_traj(cfg, dynamics_step, params, x0, u_new)
    finite = torch.isfinite(u_new).all(-1).all(-1)
    u_new = torch.where(finite[..., None, None], u_new, u)
    u_shift = torch.cat([u_new[..., 1:, :], u_new[..., -1:, :]], dim=-2)
    sidx = wp_idx if status_idx is None else status_idx
    aux = MPPIAux(S, w, optimal_traj, wp_idx, _status(params, sidx, finite))
    return u_new[..., 0, :], MPPIState(u_prev=u_shift, waypoint_idx=wp_idx, key=key), aux


def _mppi_tail_fused(cfg, dynamics_step, params, x0, key, wp_idx, S, w, u_new, u_shift, finite,
                     status_idx=None):
    """Tick tail when the kernel already filtered, updated, held and shifted
    (``status_idx``: see :func:`_mppi_tail`)."""
    optimal_traj = _optimal_traj(cfg, dynamics_step, params, x0, u_new)
    sidx = wp_idx if status_idx is None else status_idx
    aux = MPPIAux(S, w, optimal_traj, wp_idx, _status(params, sidx, finite >= 0.5))
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


class _IsoCheck:
    """For ``iso_xy``: checks the weights of each new params object once, so
    the host read stays out of the ticks that follow."""

    def __init__(self):
        self.last = None

    def __call__(self, params: MPPIParams) -> None:
        if params is not self.last:
            _check_iso_weights(params)
            self.last = params


def make_cuda_diffdrive_rollout(
    cfg: MPPIConfig, robot_radius: float = 0.5, safety_margin_rate: float = 1.5
):
    """Bind the split rollout kernel (ops/cuda/rollout.py) as ``rollout_fn``."""
    from ..ops.cuda.rollout import diffdrive_rollout_costs

    _check_tick_carry(cfg, "split rollout kernel")
    _reject_repeats(cfg, "split rollout kernel")

    def rollout(params, ctx, u, eps, x0, k_offset=0.0):
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
            safety_margin_rate=safety_margin_rate, k_offset=k_offset, T=cfg.horizon, W=W,
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
    non-finite hold and shift.

    With ``cfg.waypoint_carry="rollout"`` the kernel carries each sample's
    window start through the rollout over ``carry_window_len`` rows gathered
    from the tick anchor, and the tick returns the furthest carried index
    (a global path index) last (``supports_rollout_carry``)."""
    from ..ops.cuda.mppi_tick import diffdrive_mppi_tick

    _check_carry_modes(cfg)
    carry = cfg.waypoint_carry == "rollout"
    _reject_unported(sincos=sincos, gaussian=gaussian, fold_anchor=fold_anchor, lean=lean)
    _reject_repeats(cfg, "fused tick")
    _check_kernel_collision(collision)
    filter_np = np.ascontiguousarray(
        filter_matrix(cfg.filter.value, cfg.horizon, cfg.filter_window, cfg.savgol_polyorder).T,
        np.float32,
    )
    filter_t = {}  # device → Fᵀ tensor, made once per device

    def tick(params, ctx, u, x0, seed, noise):
        if carry:
            start, window, span = _carry_window(cfg, params, ctx, 3)
            W = window.shape[0]
        else:
            (window, W), span = _tick_window(cfg, params, ctx, 3), 0
        ft = None
        if fuse_epilogue:
            if u.device not in filter_t:
                filter_t[u.device] = torch.as_tensor(filter_np, device=u.device)
            ft = filter_t[u.device]
        out = diffdrive_mppi_tick(
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
            rollout_carry=carry, carry_W=span,
        )
        if not carry:
            return out
        *out, wp_adv = out
        return (*out, _carried_global(start, wp_adv, params.ref_path.shape[0]))

    tick.fused_epilogue = fuse_epilogue
    tick.supports_control_cost = True
    tick.supports_rollout_carry = carry
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

    _check_tick_carry(cfg, "K-blocked fused tick")
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

    _check_tick_carry(cfg, "split bicycle rollout")
    _reject_last(cfg, "split bicycle rollout")
    _reject_repeats(cfg, "split bicycle rollout")
    vehicle = dict(wheel_base=wheel_base, vehicle_length=vehicle_length,
                   vehicle_width=vehicle_width, margin_rate=margin_rate)

    def rollout(params, ctx, u, eps, x0, k_offset=0.0):
        args = _bicycle_kernel_args(cfg, params, ctx, u, x0, vehicle, "split bicycle rollout")
        return bicycle_rollout_costs(eps.contiguous(), k_offset=k_offset, **args)

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

    _check_tick_carry(cfg, "fused bicycle tick")
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


class _SigmaFactors:
    """Σ's Cholesky factor and inverse, computed once per params object, as
    :class:`_IsoCheck` checks once: at nu = 4 the unrolled float64 inverse
    is dozens of 0-d ops, which would otherwise run every tick. A new Σ
    comes with a new params object (``dataclasses.replace``), not by
    changing ``params.sigma`` in place."""

    def __init__(self):
        self.last = None

    def __call__(self, params: MPPIParams) -> Tuple[torch.Tensor, torch.Tensor]:
        if params is not self.last:
            self.chol, self.inverse = small_cholesky(params.sigma), sigma_inverse(params.sigma)
            self.last = params
        return self.chol, self.inverse


def _generic_setup(cfg, step_tile, collision, what, carries: bool = False):
    """The checks both generic binders make at construction (``carries``:
    the binder implements ``waypoint_carry="rollout"``); the state width
    (the tile step's, or ``cfg.dim_x`` for a lifted step)."""
    if carries:
        _check_carry_modes(cfg)
    else:
        _check_tick_carry(cfg, what)
    _reject_repeats(cfg, what)
    if collision not in ("circle", "soft"):
        raise ValueError(
            f"the {what} takes collision 'circle' or 'soft', got {collision!r} "
            "(the vehicle polygon is the race car's: make_cuda_bicycle_tick)"
        )
    if cfg.time_varying_dynamics != getattr(step_tile, "takes_t", False):
        raise ValueError(
            "time_varying_dynamics must match the tile step: a step built with "
            "lift_dynamics_time_varying takes t, every other step does not"
        )
    nx = getattr(step_tile, "nx", None)
    if nx is not None and nx != cfg.dim_x:
        raise ValueError(f"the tile step has nx={nx}, the config dim_x={cfg.dim_x}")
    return cfg.dim_x


def _generic_kernel_args(cfg, params, ctx, u, energy_inverse, n_track_what, carry=False):
    """This tick's window, energy rows and tracked width for the generic
    kernels (one n_track for both costs, as in JAX); with ``carry`` the
    carry window (:func:`_carry_window`), its anchor and the search span."""
    n_track = int(params.stage_weight.shape[0])
    if params.terminal_weight.shape[0] != n_track:
        raise ValueError(
            f"the {n_track_what} tracks one n_track for both costs — stage_weight has "
            f"{n_track} dims, terminal_weight {params.terminal_weight.shape[0]}; use the "
            "scan path for asymmetric weights"
        )
    a = (cfg.gamma * matmul_f32(u, energy_inverse)).contiguous()
    if carry:
        start, window, span = _carry_window(cfg, params, ctx, n_track)
        return dict(a=a, window=window, W=window.shape[0], n_track=n_track, start=start,
                    span=span)
    window, W = _tick_window(cfg, params, ctx, n_track)
    return dict(a=a, window=window, W=W, n_track=n_track, span=0)


def make_cuda_generic_tick(
    cfg: MPPIConfig,
    step_tile,
    *,
    wrap_yaw: bool = False,
    collision: str = "circle",
    robot_radius: float = 0.5,
    soft_safety_distance: float = 2.0,
    soft_weight: float = 100.0,
    gaussian: str = "hash",
    fuse_epilogue: bool = False,
    safety_margin_rate: float = 1.5,
):
    """Bind the generic tick (ops/cuda/generic_tick.py) as ``tick_fn`` for
    any tile-step dynamics (``models/tile.py``): ε from the hash stream
    seeded by the carried key, or injected; the tracking costs of
    :func:`make_tracking_costs` over the first n_track = len(stage_weight)
    state dims (wrap-yaw on dim 2), circle or soft obstacles with drift,
    SUM or LAST. With ``fuse_epilogue`` the kernel also applies the filter,
    update, non-finite hold and shift.

    On the card the step must be of a built-in family; a lifted or
    time-varying step runs on CPU tensors only. Repeats, a collision other
    than circle or soft and stage/terminal weights of different lengths
    raise ``ValueError``. ``cfg.waypoint_carry="rollout"`` carries each
    sample's window start as the diff-drive tick does
    (:func:`make_cuda_diffdrive_tick`)."""
    from ..ops.cuda.generic_tick import generic_mppi_tick

    _reject_unported(gaussian=gaussian)
    nx = _generic_setup(cfg, step_tile, collision, "generic fused tick", carries=True)
    carry = cfg.waypoint_carry == "rollout"
    filter_np = np.ascontiguousarray(
        filter_matrix(cfg.filter.value, cfg.horizon, cfg.filter_window, cfg.savgol_polyorder).T,
        np.float32,
    )
    filter_t = {}  # device → Fᵀ tensor, made once per device
    factors = _SigmaFactors()

    def tick(params, ctx, u, x0, seed, noise):
        chol, inverse = factors(params)
        args = _generic_kernel_args(cfg, params, ctx, u, inverse, "generic fused tick", carry)
        ft = None
        if fuse_epilogue:
            if u.device not in filter_t:
                filter_t[u.device] = torch.as_tensor(filter_np, device=u.device)
            ft = filter_t[u.device]
        out = generic_mppi_tick(
            seed, u, args["a"], chol, x0, args["window"], params.stage_weight,
            params.terminal_weight, params.u_min, params.u_max, cfg.dt,
            (1.0 - cfg.exploration) * cfg.num_samples, cfg.inv_temperature,
            obstacles=params.obstacles, robot_radius=robot_radius,
            safety_margin_rate=safety_margin_rate,
            eps=None if noise is None else noise.contiguous(),
            obstacle_velocities=params.obstacle_velocities,
            soft_safety_distance=soft_safety_distance, soft_weight=soft_weight,
            filter_t=ft, step_tile=step_tile, nx=nx, nu=cfg.dim_u, n_track=args["n_track"],
            K=cfg.num_samples, T=cfg.horizon, W=args["W"], wrap_yaw=wrap_yaw,
            last_only=cfg.accumulation == CostAccumulation.LAST, collision=collision,
            fuse_epilogue=fuse_epilogue, step_takes_t=cfg.time_varying_dynamics,
            rollout_carry=carry, carry_W=args["span"],
        )
        if not carry:
            return out
        *out, wp_adv = out
        return (*out, _carried_global(args["start"], wp_adv, params.ref_path.shape[0]))

    tick.fused_epilogue = fuse_epilogue
    tick.supports_rollout_carry = carry
    return tick


def make_cuda_generic_rollout(
    cfg: MPPIConfig,
    step_tile,
    *,
    wrap_yaw: bool = False,
    collision: str = "circle",
    robot_radius: float = 0.5,
    soft_safety_distance: float = 2.0,
    soft_weight: float = 100.0,
    safety_margin_rate: float = 1.5,
):
    """Bind the generic rollout kernel as ``rollout_fn`` for any tile-step
    dynamics — the sample-sharded counterpart of
    :func:`make_cuda_generic_tick`, with its cost semantics. Under a process
    group each rank rolls out its K/n samples with their global
    ``k_offset`` (the exploration split stays over the global K); ρ, η and
    Σw·ε are then all-reduced in :func:`mppi_step`."""
    from ..ops.cuda.generic_tick import generic_rollout_costs

    nx = _generic_setup(cfg, step_tile, collision, "generic rollout kernel")
    factors = _SigmaFactors()

    def rollout(params, ctx, u, eps, x0, k_offset=0.0):
        _, inverse = factors(params)
        args = _generic_kernel_args(cfg, params, ctx, u, inverse, "generic rollout kernel")
        return generic_rollout_costs(
            eps.contiguous(), u, args["a"], x0, args["window"], params.stage_weight,
            params.terminal_weight, params.u_min, params.u_max, cfg.dt,
            (1.0 - cfg.exploration) * cfg.num_samples, obstacles=params.obstacles,
            robot_radius=robot_radius, safety_margin_rate=safety_margin_rate,
            obstacle_velocities=params.obstacle_velocities,
            soft_safety_distance=soft_safety_distance, soft_weight=soft_weight,
            k_offset=k_offset, step_tile=step_tile, nx=nx, nu=cfg.dim_u,
            n_track=args["n_track"], T=cfg.horizon, W=args["W"], wrap_yaw=wrap_yaw,
            last_only=cfg.accumulation == CostAccumulation.LAST, collision=collision,
            step_takes_t=cfg.time_varying_dynamics,
        )

    return rollout


def _on_device(device, **tensors) -> None:
    """Raise unless every given tensor lies on ``device``: a step built for
    one device does not run on another."""
    for name, t in tensors.items():
        if t.device != device:
            raise ValueError(
                f"{name} is on {t.device}, but this step was built for {device} "
                "(pass device= to run it elsewhere)"
            )


def _warm_filter(cfg: MPPIConfig, device: torch.device) -> None:
    """Copy the smoothing filter to ``device`` once, at construction, so the
    first tick does not wait for a host-to-device copy (and a missing card
    is reported here)."""
    if cfg.filter != SmoothingFilter.NONE:
        filter_tensor(cfg.filter.value, cfg.horizon, cfg.filter_window, cfg.savgol_polyorder,
                      torch.float32, device)


def make_fleet_fused_mppi_step(
    cfg: MPPIConfig,
    dynamics_step: Callable,
    robot_radius: float = 0.5,
    collision: str = "circle",
    soft_safety_distance: float = 2.0,
    soft_weight: float = 100.0,
    iso_xy: bool = False,
    sincos: str = "native",
    safety_margin_rate: float = 1.5,
    device="cuda",
):
    """B independent diff-drive MPPI controllers per tick, the counterpart of
    the JAX ``make_fleet_fused_mppi_step`` (``solvers/mppi.py:1514``).

    Returns ``step(params, states, x0s) -> (u0s, states, auxs)``: ``params``
    is one shared :class:`MPPIParams` whose ``ref_path`` (and optional
    ``obstacles`` / ``obstacle_velocities``) may carry a leading member axis
    for per-member references; ``states`` is a fleet :class:`MPPIState`
    (leading B, :meth:`MPPIState.fleet`); ``x0s`` is (B, 3). The sample-space
    work of all B members is one call of ``fleet_mppi_tick`` (ε from each
    member's carried key through the hash stream); the waypoint search and
    the tick tail are written over the member axis, not a loop.

    ``sincos``: the JAX default is ``"poly"``, a TPU-only polynomial; the
    port's kernels use ``sincosf``, so the default here is ``"native"`` and
    ``"poly"`` raises, as in every other binder. ``num_rollout_repeats > 1``
    and ``params.control_weight`` raise, as in JAX. The step runs on
    ``device``; tensors elsewhere raise ``ValueError``."""
    from ..ops.cuda.mppi_tick_blocked import fleet_mppi_tick

    _check_tick_carry(cfg, "fleet fused tick")
    _reject_unported(sincos=sincos)
    _reject_repeats(cfg, "fleet fused tick")
    _check_kernel_collision(collision)
    device = resolve_device(device)
    _warm_filter(cfg, device)
    iso_check = _IsoCheck()

    def step(params: MPPIParams, states: MPPIState, x0s: torch.Tensor):
        if params.control_weight is not None:
            raise ValueError(
                "params.control_weight (the pytorch_mppi action cost) is not "
                "implemented in the fleet tick — use per-member MPPISolver steps"
            )
        u = states.u_prev  # (B, T, nu)
        _on_device(device, u_prev=u, x0s=x0s, ref_path=params.ref_path)
        if iso_xy:
            iso_check(params)
        B = x0s.shape[0]
        x0s = x0s.to(u.dtype)
        wp_idx, _ = fleet_nearest_waypoint(
            params.ref_path, x0s[:, :2], states.waypoint_idx, cfg.waypoint_search_len
        )
        _, windows = fleet_waypoint_windows(params.ref_path, wp_idx, cfg.waypoint_search_len)
        obstacles, velocities = params.obstacles, params.obstacle_velocities
        if obstacles is not None and obstacles.dim() == 2:
            obstacles = obstacles.expand((B,) + obstacles.shape)
        if velocities is not None and velocities.dim() == 2:
            velocities = velocities.expand((B,) + velocities.shape)
        S, w, w_eps = fleet_mppi_tick(
            tick_seed(states.key), u.contiguous(), _energy_rows(cfg, params, u),
            small_cholesky(params.sigma), x0s.contiguous(), windows[..., :3].contiguous(),
            params.stage_weight, params.terminal_weight, params.u_min, params.u_max,
            cfg.dt, (1.0 - cfg.exploration) * cfg.num_samples, cfg.inv_temperature,
            obstacles=obstacles, robot_radius=robot_radius,
            safety_margin_rate=safety_margin_rate, obstacle_velocities=velocities,
            soft_safety_distance=soft_safety_distance, soft_weight=soft_weight,
            B=B, K=cfg.num_samples, T=cfg.horizon, W=windows.shape[1],
            last_only=cfg.accumulation == CostAccumulation.LAST,
            collision=collision, iso_xy=iso_xy,
        )
        return _mppi_tail(cfg, dynamics_step, params, x0s, u, advance_key(states.key), wp_idx,
                          S, w, w_eps)

    step.cfg = cfg
    return step


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

    ``fused_tick=True`` binds the generic tick over ``tile_dynamics`` when
    one is given (a tile step of ``models/tile.py``, with ``wrap_yaw`` and
    ``collision`` for its costs), else the diff-drive fused tick, or the
    K-blocked tick when 16·T·K bytes exceed 10 MiB (the JAX package's rule);
    ``use_kernel`` (default ``cfg.use_kernel``) binds the split rollout
    kernel otherwise. Tensors on ``device`` decide where each tick runs: a
    CUDA device (the default) launches the kernels, ``device="cpu"`` runs
    their plain versions. A lifted or time-varying tile step has no kernel:
    on the card it raises here, on the CPU it runs.

    :meth:`fleet_step` gives the fleet step whose members each run this
    solver's tick, where there is one.
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
        wrap_yaw: bool = False,
        collision: str = "circle",
        soft_safety_distance: float = 2.0,
        soft_weight: float = 100.0,
        fuse_epilogue: bool = True,
        iso_xy: bool = False,
        fold_anchor: Optional[bool] = None,
        lean: Optional[bool] = None,
        sincos: str = "native",
        device="cuda",
        seed: int = 0,
    ) -> None:
        _check_carry_modes(cfg)
        _reject_unported(sincos=sincos, gaussian=gaussian, fold_anchor=fold_anchor, lean=lean)
        use_kernel = cfg.use_kernel if use_kernel is None else use_kernel
        if cfg.time_varying_dynamics and (use_kernel or fused_tick) and (
            tile_dynamics is None and tick_fn is None and rollout_fn is None
        ):
            raise ValueError(
                "time_varying_dynamics needs the scan path, a generic rollout_fn, or the "
                "generic tick (tile_dynamics built with lift_dynamics_time_varying): the "
                "diff-drive kernels compile their dynamics in"
            )
        if tile_dynamics is not None and not fused_tick and tick_fn is None:
            raise ValueError(
                "tile_dynamics is only used by the fused tick kernel — pass fused_tick=True "
                "(or bind make_cuda_generic_rollout as rollout_fn for the split and "
                "sample-sharded paths)"
            )
        self.cfg = cfg
        self.dynamics_step = dynamics_step
        self.stage_cost = stage_cost
        self.terminal_cost = terminal_cost
        self.device = resolve_device(device)
        self._fleet = None
        generic = tick_fn is None and fused_tick and tile_dynamics is not None
        if generic and self.device.type == "cuda":
            from ..ops.cuda.generic_tick import kernel_model

            kernel_model(tile_dynamics, cfg.time_varying_dynamics)  # raises without a kernel
        self.generator = torch.Generator(device=self.device).manual_seed(seed)
        if generic:
            tick_fn = make_cuda_generic_tick(
                cfg, tile_dynamics, wrap_yaw=wrap_yaw, collision=collision,
                robot_radius=robot_radius, soft_safety_distance=soft_safety_distance,
                soft_weight=soft_weight, gaussian=gaussian, fuse_epilogue=fuse_epilogue,
                safety_margin_rate=safety_margin_rate,
            )
        if tick_fn is None and fused_tick:
            if _EPS_BYTES_PER_SAMPLE_STEP * cfg.horizon * cfg.num_samples > _SINGLE_BLOCK_VMEM_BUDGET:
                if cfg.waypoint_carry == "rollout":
                    raise ValueError(
                        "waypoint_carry='rollout' is implemented in the single-block fused "
                        "tick (K·T under the JAX package's budget) and the generic tick — "
                        "reduce num_samples/horizon or use the scan path at this scale"
                    )
                tick_fn = make_cuda_diffdrive_tick_blocked(
                    cfg, robot_radius, k_block=_pick_k_block(cfg.num_samples, cfg.horizon),
                    collision=collision, soft_safety_distance=soft_safety_distance,
                    soft_weight=soft_weight, iso_xy=iso_xy,
                    safety_margin_rate=safety_margin_rate,
                )
            else:
                if cfg.waypoint_carry == "tick":
                    self._fleet = functools.partial(
                        make_fleet_fused_mppi_step, cfg, dynamics_step,
                        robot_radius=robot_radius, collision=collision,
                        soft_safety_distance=soft_safety_distance, soft_weight=soft_weight,
                        iso_xy=iso_xy, safety_margin_rate=safety_margin_rate,
                        device=self.device,
                    )
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
        self._iso_check = _IsoCheck()

    def init(self, key=None) -> MPPIState:
        return MPPIState.init(self.cfg, key, device=self.device)

    def step(
        self,
        params: MPPIParams,
        state: MPPIState,
        x0: torch.Tensor,
        noise: Optional[torch.Tensor] = None,
    ) -> Tuple[torch.Tensor, MPPIState, MPPIAux]:
        if getattr(self.tick_fn, "iso_xy", False):
            self._iso_check(params)
        return mppi_step(
            self.cfg, self.dynamics_step, self.stage_cost, self.terminal_cost,
            params, state, x0, noise, rollout_fn=self.rollout_fn,
            tick_fn=self.tick_fn, generator=self.generator,
        )

    def fleet_step(self):
        """``make_fleet_fused_mppi_step`` with this solver's config, dynamics
        and binder options when its tick is the single-block diff-drive
        fused tick with the tick-level waypoint carry, else None. A member
        draws its own key's hash stream, the single-block tick's: its S is
        this solver's bit for bit given equal inputs; its tail (filter,
        update, shift) runs in PyTorch whatever ``fuse_epilogue`` says, so u0
        may differ by rounding."""
        return None if self._fleet is None else self._fleet()

    def sampled_trajectories(self, params, state, x0, noise, costs, top_fraction=1.0):
        """:func:`sampled_trajectories` with this solver's config and
        dynamics."""
        return sampled_trajectories(self.cfg, self.dynamics_step, params, state, x0, noise,
                                    costs, top_fraction=top_fraction)


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
    "make_cuda_generic_rollout",
    "make_cuda_generic_tick",
    "make_fleet_fused_mppi_step",
    "make_tracking_costs",
    "mppi_step",
    "resolve_device",
    "sampled_trajectories",
    "state_from_numpy",
    "tick_seed",
]
