"""Generic MPPI tick and split rollout for any tile-step dynamics.

Counterpart of ``dnn_mppi_mpc_tpu/ops/pallas/generic_tick.py``:
:func:`generic_mppi_tick` (``:442``: ε, rollout, softmax, Σw·ε and the
optional fused epilogue) and :func:`generic_rollout_costs` (``:665``: the
rollout alone for one shard of the sample-sharded scan step, with the
shard's ``k_offset``). On CUDA tensors they launch ``dmm_generic_tick`` and
``dmm_generic_rollout_costs`` (csrc/generic_kernels.cu); on CPU tensors they
run :func:`generic_mppi_tick_plain` and :func:`generic_rollout_costs_plain`,
the same computation in plain PyTorch in the kernel's order of operations.

The kernel compiles in the four built-in tile-step families of
``models/tile.py``. A lifted step (``lift_dynamics``, family None), a
time-varying step (``step_takes_t``) and the per-rollout waypoint carry have
no kernel: on CUDA tensors they raise ``ValueError`` — write a tile step of a
built-in family for the card. The plain version runs lifted and
time-varying steps on CPU tensors.

Noise: ε is injected (K, T, nu), or drawn from the hash stream of
``ops/cuda/mathx.py`` as one block of K samples (pair p of sample k at step
t at counter (p·T + t)·K + k; for nu = 2 the diff-drive tick's stream). The
Σw·ε pass draws the hash ε again instead of storing it.
"""

from __future__ import annotations

import ctypes
from typing import Callable, Optional

import numpy as np
import torch

from ..._build import GENERIC_CONSTANTS, DmmGenericArgs, launch
from ...models.tile import FAMILIES
from . import common
from .common import (
    TWO_PI, _obstacle_plain, check, check_seed, f32, on_cuda, softmax_plain,
    weighted_noise_plain,
)
from .mathx import hash_noise
from .mppi_tick import _OBS_MODES, effective_robot_radius, fused_epilogue_plain, pack_obstacles

_INV_TWO_PI = f32(1.0 / (2.0 * np.pi))


def check_staging(T: int, W: int, n_track: int, nu: int, n_obs: int) -> None:
    """Raise unless the generic kernels can stage u, a (T, nu each), the
    (W, n_track) window and the (n, 5) obstacles in shared memory."""
    common.check_staging("generic", 2 * nu * T + n_track * W + 5 * n_obs,
                         f"u, a, the (W={W}, {n_track}) window and {n_obs} obstacles")


def _check_args(step_tile, nx: int, nu: int, n_track: int, window: torch.Tensor,
                collision: str) -> None:
    if collision not in _OBS_MODES:
        raise ValueError(f"collision must be 'circle' or 'soft', got {collision!r}")
    if not 2 <= n_track <= nx:
        raise ValueError(f"n_track={n_track} must be in [2, nx={nx}]: tracking needs (x, y)")
    if window.shape[-1] < n_track:
        raise ValueError(f"the window has {window.shape[-1]} columns < n_track={n_track}")
    step_nx, step_nu = getattr(step_tile, "nx", None), getattr(step_tile, "nu", None)
    if (step_nx, step_nu) != (None, None) and (step_nx, step_nu) != (nx, nu):
        raise ValueError(
            f"the tile step is of nx={step_nx}, nu={step_nu}, the call of nx={nx}, nu={nu}"
        )


def kernel_model(step_tile, step_takes_t: bool, rollout_carry: bool = False) -> int:
    """The kernel's ``model`` field for the step, or ``ValueError`` for what
    the kernel cannot run."""
    if rollout_carry:
        raise ValueError("rollout_carry (waypoint_carry='rollout') is not ported: no kernel "
                         "implements the per-rollout waypoint carry")
    if step_takes_t:
        raise ValueError("step_takes_t (a time-varying tile step) has no kernel: it runs in "
                         "the plain version on CPU tensors")
    family = getattr(step_tile, "family", None)
    if family not in FAMILIES:
        raise ValueError(
            "the generic kernel compiles in the tile steps of the built-in families "
            f"{', '.join(FAMILIES)} (models/tile.py); a lifted step (lift_dynamics) runs "
            "only on CPU tensors — write a tile step of one of these families for the card"
        )
    return FAMILIES.index(family)


def _constants(step_tile) -> ctypes.Array:
    """The tile step's float32 constants as ``DmmGenericArgs::c``."""
    return (ctypes.c_float * GENERIC_CONSTANTS)(*step_tile.constants)


def _tracking_plain(xs, window, w, wrap_yaw: bool) -> torch.Tensor:
    """Tracking cost of each sample against its nearest window row (the
    kernel's running min over (x, y) with the first-strict-< rule,
    ``common.running_min_index``); the plain twin of ``dmm_generic_tracking``."""
    dx = xs[0][:, None] - window[:, 0]
    dy = xs[1][:, None] - window[:, 1]
    d = dx * dx + dy * dy  # (K, W)
    ref = window.index_select(0, common.running_min_index(d))  # (K, n_track)
    c = torch.zeros_like(xs[0])
    for i in range(w.shape[0]):
        xi = xs[i]
        if wrap_yaw and i == 2:
            xi = xi - TWO_PI * torch.floor(xi * _INV_TWO_PI)
        e = xi - ref[:, i]
        c = c + w[i] * e * e
    return c


def generic_rollout_body_plain(
    eps: torch.Tensor,  # (K, T, nu)
    u: torch.Tensor,
    a: torch.Tensor,
    x0: torch.Tensor,
    window: torch.Tensor,  # (W, n_track)
    stage_w: torch.Tensor,
    term_w: torch.Tensor,
    u_min: torch.Tensor,
    u_max: torch.Tensor,
    *,
    step_tile: Callable,
    dt: float,
    n_exploit: float,
    k_offset: float = 0.0,
    obstacles: Optional[torch.Tensor] = None,  # (n, 5) packed rows
    obs_mode: str = "circle",
    obs_radius: float = 0.0,
    drift: bool = False,
    soft_dist: float = 0.0,
    soft_w: float = 0.0,
    wrap_yaw: bool = False,
    last_only: bool = False,
    step_takes_t: bool = False,
) -> torch.Tensor:
    """Per-sample costs S (K,) — the plain twin of ``dmm_generic_sample`` in
    csrc/generic_rollout.cuh (same operations in the same order)."""
    K, T, nu = eps.shape
    dt, obs_radius, soft_dist, soft_w = f32(dt), f32(obs_radius), f32(soft_dist), f32(soft_w)
    exploit = torch.arange(K, dtype=torch.float32, device=eps.device) + f32(k_offset) < f32(n_exploit)
    xs = tuple(x0[i].expand(K) for i in range(x0.shape[0]))
    S = torch.zeros(K, dtype=torch.float32, device=eps.device)
    n_obs = 0 if obstacles is None else obstacles.shape[0]
    for t in range(T):
        vs, energy = [], None
        for j in range(nu):
            e = eps[:, t, j]
            v = torch.clamp(torch.where(exploit, u[t, j] + e, e), u_min[j], u_max[j])
            vs.append(v)
            term = a[t, j] * v
            energy = term if energy is None else energy + term
        xs = tuple(step_tile(xs, tuple(vs), t) if step_takes_t else step_tile(xs, tuple(vs)))
        if len(xs) != x0.shape[0]:
            raise ValueError(f"the tile step returned {len(xs)} state dims, expected {x0.shape[0]}")
        cost = _tracking_plain(xs, window, stage_w, wrap_yaw) + energy
        if n_obs:
            t_f = float(np.float32(t) * np.float32(dt)) if drift else None
            cost = cost + _obstacle_plain(xs[0], xs[1], obstacles, obs_mode, obs_radius,
                                          soft_dist, soft_w, t_f)
        S = cost if last_only else S + cost
    S = S + _tracking_plain(xs, window, term_w, wrap_yaw)
    if n_obs:
        S = S + _obstacle_plain(xs[0], xs[1], obstacles, obs_mode, obs_radius, soft_dist,
                                soft_w, None)
    return S


def _plain_rollout(eps, u, a, x0, window, stage_w, term_w, u_min, u_max, dt, n_exploit,
                   obstacles, robot_radius, safety_margin_rate, obstacle_velocities,
                   soft_safety_distance, soft_weight, k_offset, *, step_tile, n_track, W,
                   wrap_yaw, last_only, collision, step_takes_t):
    obs, _ = pack_obstacles(obstacles, obstacle_velocities)
    return generic_rollout_body_plain(
        eps, u, a, x0, window[:W, :n_track], stage_w, term_w, u_min, u_max,
        step_tile=step_tile, dt=dt, n_exploit=n_exploit, k_offset=k_offset, obstacles=obs,
        obs_mode=collision,
        obs_radius=effective_robot_radius(robot_radius, safety_margin_rate),
        drift=obstacle_velocities is not None, soft_dist=soft_safety_distance,
        soft_w=soft_weight, wrap_yaw=wrap_yaw, last_only=last_only, step_takes_t=step_takes_t,
    )


def _fill_args(*, model, step_tile, u, a, x0, window, stage_w, term_w, u_min, u_max, dt,
               n_exploit, obstacles, obstacle_velocities, robot_radius, safety_margin_rate,
               soft_safety_distance, soft_weight, k_offset, nx, nu, n_track, K, T, W,
               wrap_yaw, last_only, collision) -> dict:
    """The fields of ``DmmGenericArgs`` both entry points share, checked."""
    dev = u.device
    obs, n_obs = pack_obstacles(obstacles, obstacle_velocities)
    check_staging(T, W, n_track, nu, n_obs)
    return dict(
        u=check("u", u, (T, nu), dev),
        a=check("a", a, (T, nu), dev),
        x0=check("x0", x0, (nx,), dev),
        window=check("window", window, (W, n_track), dev),
        stage_w=check("stage_w", stage_w, (n_track,), dev),
        term_w=check("term_w", term_w, (n_track,), dev),
        u_min=check("u_min", u_min, (nu,), dev),
        u_max=check("u_max", u_max, (nu,), dev),
        obstacles=check("obstacles", obs, (n_obs, 5), dev),
        model=model, K=K, T=T, W=W, n_track=n_track, n_obs=n_obs,
        last_only=int(last_only), obs_mode=_OBS_MODES[collision],
        drift=int(obstacle_velocities is not None), wrap_yaw=int(wrap_yaw),
        dt=f32(dt), n_exploit=f32(n_exploit), k_offset=f32(k_offset),
        obs_radius=f32(effective_robot_radius(robot_radius, safety_margin_rate)),
        soft_dist=f32(soft_safety_distance), soft_w=f32(soft_weight),
        c=_constants(step_tile),
    )


def _window(window: torch.Tensor, W: int, n_track: int) -> torch.Tensor:
    """The kernel's (W, n_track) window rows, contiguous."""
    if window.shape[-1] == n_track and window.shape[0] == W and window.is_contiguous():
        return window
    return window[:W, :n_track].contiguous()


# --- the split rollout ---------------------------------------------------------


def generic_rollout_costs_plain(
    eps, u, a, x0, window, stage_w, term_w, u_min, u_max, dt, n_exploit,
    obstacles=None, robot_radius=0.5, safety_margin_rate=1.5, obstacle_velocities=None,
    soft_safety_distance=2.0, soft_weight=100.0, k_offset=0.0, *, step_tile, nx: int,
    nu: int, n_track: int, T: int, W: int, wrap_yaw: bool = False, last_only: bool = False,
    collision: str = "circle", step_takes_t: bool = False,
) -> torch.Tensor:
    """Plain PyTorch version of :func:`generic_rollout_costs`."""
    generic_rollout_costs_plain.calls += 1
    _check_args(step_tile, nx, nu, n_track, window, collision)
    return _plain_rollout(
        eps, u, a, x0, window, stage_w, term_w, u_min, u_max, dt, n_exploit, obstacles,
        robot_radius, safety_margin_rate, obstacle_velocities, soft_safety_distance,
        soft_weight, k_offset, step_tile=step_tile, n_track=n_track, W=W, wrap_yaw=wrap_yaw,
        last_only=last_only, collision=collision, step_takes_t=step_takes_t,
    )


generic_rollout_costs_plain.calls = 0


def generic_rollout_costs(
    eps: torch.Tensor,  # (K_local, T, nu) injected ε of this shard
    u: torch.Tensor,  # (T, nu)
    a: torch.Tensor,  # (T, nu) γ·u_tᵀΣ⁻¹
    x0: torch.Tensor,  # (nx,)
    window: torch.Tensor,  # (W, >= n_track)
    stage_w: torch.Tensor,  # (n_track,)
    term_w: torch.Tensor,  # (n_track,)
    u_min: torch.Tensor,  # (nu,)
    u_max: torch.Tensor,  # (nu,)
    dt: float,
    n_exploit: float,  # over the global K
    obstacles: Optional[torch.Tensor] = None,  # (n_obs, 2|3)
    robot_radius: float = 0.5,  # physical radius; the margin is applied here
    safety_margin_rate: float = 1.5,
    obstacle_velocities: Optional[torch.Tensor] = None,  # (n_obs, 2) drift
    soft_safety_distance: float = 2.0,
    soft_weight: float = 100.0,
    k_offset: float = 0.0,  # global index of this shard's first sample
    *,
    step_tile,
    nx: int,
    nu: int,
    n_track: int,
    T: int,
    W: int,
    wrap_yaw: bool = False,
    last_only: bool = False,
    collision: str = "circle",
    step_takes_t: bool = False,
) -> torch.Tensor:
    """Per-sample costs S (K_local,) of the rollout alone: the sample-sharded
    counterpart of :func:`generic_mppi_tick`, bound as the scan step's
    ``rollout_fn`` (``solvers.mppi.make_cuda_generic_rollout``)."""
    if not on_cuda(u, eps=eps, a=a, x0=x0, window=window, obstacles=obstacles):
        return generic_rollout_costs_plain(
            eps, u, a, x0, window, stage_w, term_w, u_min, u_max, dt, n_exploit, obstacles,
            robot_radius, safety_margin_rate, obstacle_velocities, soft_safety_distance,
            soft_weight, k_offset, step_tile=step_tile, nx=nx, nu=nu, n_track=n_track, T=T,
            W=W, wrap_yaw=wrap_yaw, last_only=last_only, collision=collision,
            step_takes_t=step_takes_t,
        )
    _check_args(step_tile, nx, nu, n_track, window, collision)
    model = kernel_model(step_tile, step_takes_t)
    dev = u.device
    K = eps.shape[0]
    check("eps", eps, (K, T, nu), dev)
    eps_t = eps.transpose(0, 1).contiguous()  # (T, K, nu): coalesced per step
    S = torch.empty(K, dtype=torch.float32, device=dev)
    fields = _fill_args(
        model=model, step_tile=step_tile, u=u, a=a, x0=x0, window=_window(window, W, n_track),
        stage_w=stage_w, term_w=term_w, u_min=u_min, u_max=u_max, dt=dt, n_exploit=n_exploit,
        obstacles=obstacles, obstacle_velocities=obstacle_velocities,
        robot_radius=robot_radius, safety_margin_rate=safety_margin_rate,
        soft_safety_distance=soft_safety_distance, soft_weight=soft_weight,
        k_offset=k_offset, nx=nx, nu=nu, n_track=n_track, K=K, T=T, W=W,
        wrap_yaw=wrap_yaw, last_only=last_only, collision=collision,
    )
    launch("dmm_generic_rollout_costs",
           DmmGenericArgs(eps=eps_t.data_ptr(), S=S.data_ptr(), eps_mode=0, **fields), dev)
    generic_rollout_costs.launches += 1
    return S


generic_rollout_costs.launches = 0


# --- the fused tick -------------------------------------------------------------


def generic_mppi_tick_plain(
    seed, u, a, chol_sigma, x0, window, stage_w, term_w, u_min, u_max, dt, n_exploit,
    inv_temperature, obstacles=None, robot_radius=0.5, safety_margin_rate=1.5, eps=None,
    obstacle_velocities=None, soft_safety_distance=2.0, soft_weight=100.0, filter_t=None,
    k_offset=0.0, *, step_tile, nx: int, nu: int, n_track: int, K: int, T: int, W: int,
    wrap_yaw: bool = False, last_only: bool = False, emit_eps: bool = False,
    collision: str = "circle", fuse_epilogue: bool = False, step_takes_t: bool = False,
    rollout_carry: bool = False,
):
    """Plain PyTorch version of :func:`generic_mppi_tick`."""
    generic_mppi_tick_plain.calls += 1
    _check_args(step_tile, nx, nu, n_track, window, collision)
    if rollout_carry:
        kernel_model(step_tile, False, True)  # raises: not ported
    if eps is None:
        eps = hash_noise(seed, chol_sigma, K, T, K)
    S = _plain_rollout(
        eps, u, a, x0, window, stage_w, term_w, u_min, u_max, dt, n_exploit, obstacles,
        robot_radius, safety_margin_rate, obstacle_velocities, soft_safety_distance,
        soft_weight, k_offset, step_tile=step_tile, n_track=n_track, W=W, wrap_yaw=wrap_yaw,
        last_only=last_only, collision=collision, step_takes_t=step_takes_t,
    )
    _, _, w = softmax_plain(S, inv_temperature)
    w_eps = weighted_noise_plain(w, eps)
    out = [S, w, w_eps]
    if fuse_epilogue:
        out.append(fused_epilogue_plain(w_eps, filter_t, u))
    if emit_eps:
        out.append(eps)
    return tuple(out)


generic_mppi_tick_plain.calls = 0


def generic_mppi_tick(
    seed: Optional[torch.Tensor],  # (1,) int64 holding the uint32 seed; unused with eps
    u: torch.Tensor,  # (T, nu) nominal sequence
    a: torch.Tensor,  # (T, nu) γ·u_tᵀΣ⁻¹
    chol_sigma: torch.Tensor,  # (nu, nu) lower Cholesky factor of Σ
    x0: torch.Tensor,  # (nx,)
    window: torch.Tensor,  # (W, >= n_track) waypoint window
    stage_w: torch.Tensor,  # (n_track,)
    term_w: torch.Tensor,  # (n_track,)
    u_min: torch.Tensor,  # (nu,)
    u_max: torch.Tensor,  # (nu,)
    dt: float,
    n_exploit: float,
    inv_temperature: float,
    obstacles: Optional[torch.Tensor] = None,  # (n_obs, 2|3)
    robot_radius: float = 0.5,  # physical radius; the margin is applied here
    safety_margin_rate: float = 1.5,
    eps: Optional[torch.Tensor] = None,  # (K, T, nu) injected ε
    obstacle_velocities: Optional[torch.Tensor] = None,  # (n_obs, 2) drift
    soft_safety_distance: float = 2.0,
    soft_weight: float = 100.0,
    filter_t: Optional[torch.Tensor] = None,  # (T, T) Fᵀ for the epilogue
    k_offset: float = 0.0,  # global index of the first sample (exploration split)
    *,
    step_tile,
    nx: int,
    nu: int,
    n_track: int,
    K: int,
    T: int,
    W: int,
    wrap_yaw: bool = False,
    last_only: bool = False,
    emit_eps: bool = False,
    collision: str = "circle",
    fuse_epilogue: bool = False,
    step_takes_t: bool = False,
    rollout_carry: bool = False,
):
    """One MPPI tick for tile-step dynamics. Returns ``(S (K,), w (K,),
    w_eps (T, nu))``, then ``(u_new, u_shift, finite)`` when
    ``fuse_epilogue``, then the ε used (K, T, nu) when ``emit_eps`` — the
    JAX function's order."""
    if fuse_epilogue and filter_t is None:
        raise ValueError("fuse_epilogue=True requires the (T, T) filter_t matrix")
    if eps is None and K % 128:
        raise ValueError(f"generated ε needs K a multiple of 128, got K={K}")
    if not on_cuda(u, eps=eps, seed=seed, window=window, x0=x0, obstacles=obstacles):
        return generic_mppi_tick_plain(
            seed, u, a, chol_sigma, x0, window, stage_w, term_w, u_min, u_max, dt, n_exploit,
            inv_temperature, obstacles, robot_radius, safety_margin_rate, eps,
            obstacle_velocities, soft_safety_distance, soft_weight, filter_t, k_offset,
            step_tile=step_tile, nx=nx, nu=nu, n_track=n_track, K=K, T=T, W=W,
            wrap_yaw=wrap_yaw, last_only=last_only, emit_eps=emit_eps, collision=collision,
            fuse_epilogue=fuse_epilogue, step_takes_t=step_takes_t,
            rollout_carry=rollout_carry,
        )
    _check_args(step_tile, nx, nu, n_track, window, collision)
    model = kernel_model(step_tile, step_takes_t, rollout_carry)
    dev = u.device
    fields = _fill_args(
        model=model, step_tile=step_tile, u=u, a=a, x0=x0, window=_window(window, W, n_track),
        stage_w=stage_w, term_w=term_w, u_min=u_min, u_max=u_max, dt=dt, n_exploit=n_exploit,
        obstacles=obstacles, obstacle_velocities=obstacle_velocities,
        robot_radius=robot_radius, safety_margin_rate=safety_margin_rate,
        soft_safety_distance=soft_safety_distance, soft_weight=soft_weight,
        k_offset=k_offset, nx=nx, nu=nu, n_track=n_track, K=K, T=T, W=W,
        wrap_yaw=wrap_yaw, last_only=last_only, collision=collision,
    )
    out = {name: torch.empty(shape, dtype=torch.float32, device=dev)
           for name, shape in (("S", (K,)), ("w", (K,)), ("w_eps", (T, nu)), ("stats", (2,)))}
    if eps is not None:
        check("eps", eps, (K, T, nu), dev)
        eps_buf, eps_mode = eps.transpose(0, 1).contiguous(), 0  # (T, K, nu)
    elif emit_eps:  # draw and store ε, which Σw·ε then reads
        eps_buf, eps_mode = torch.empty((T, K, nu), dtype=torch.float32, device=dev), 1
    else:  # draw ε, and draw it again in Σw·ε
        eps_buf, eps_mode = None, 2
    if eps_mode != 0:
        fields["seed"] = check_seed(seed, dev)
    if fuse_epilogue:
        fields["filter_t"] = check("filter_t", filter_t, (T, T), dev)
        for name, shape in (("u_new", (T, nu)), ("u_shift", (T, nu)), ("finite", ())):
            out[name] = torch.empty(shape, dtype=torch.float32, device=dev)
    launch("dmm_generic_tick", DmmGenericArgs(
        chol=check("chol_sigma", chol_sigma, (nu, nu), dev),
        eps=0 if eps_buf is None else eps_buf.data_ptr(),
        eps_mode=eps_mode, inv_temp=f32(inv_temperature), fuse_epilogue=int(fuse_epilogue),
        **{name: t.data_ptr() for name, t in out.items()}, **fields,
    ), dev)
    generic_mppi_tick.launches += 1
    result = [out["S"], out["w"], out["w_eps"]]
    if fuse_epilogue:
        result.append((out["u_new"], out["u_shift"], out["finite"]))
    if emit_eps:
        result.append(eps if eps is not None else eps_buf.transpose(0, 1))
    return tuple(result)


generic_mppi_tick.launches = 0

__all__ = [
    "check_staging",
    "generic_mppi_tick",
    "generic_mppi_tick_plain",
    "generic_rollout_body_plain",
    "generic_rollout_costs",
    "generic_rollout_costs_plain",
    "kernel_model",
]
