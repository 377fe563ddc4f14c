"""Split race-car (kinematic bicycle) rollout: ε in, per-sample cost S out.

Counterpart of ``dnn_mppi_mpc_tpu/ops/pallas/rollout_bicycle.py:171
bicycle_rollout_costs``. On CUDA tensors :func:`bicycle_rollout_costs`
launches ``dmm_bicycle_rollout_costs`` (csrc/bicycle_kernels.cu); on CPU
tensors it runs :func:`bicycle_rollout_costs_plain`. The JAX kernel's
semantics: exploration split, in-rollout clamp, Euler kinematic bicycle,
yaw wrapped to [0, 2π), running-min nearest waypoint over the (W, 4) window
(typically the whole path), 4-term tracking cost, the 9-point vehicle
outline of ``ops/costs.py`` against the obstacle circles, γ·uᵀΣ⁻¹v energy
term, SUM accumulation.

:func:`bicycle_rollout_body_plain` is written in the kernel's order of
operations (csrc/bicycle_rollout.cuh), so on the card the two agree bit for
bit in S; it is also the fused bicycle tick's plain rollout.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from ..._build import OUTLINE_POINTS, DmmBicycleArgs, launch
from ..costs import VEHICLE_OUTLINE_X, VEHICLE_OUTLINE_Y
from . import common
from .common import TWO_PI, check, check_seed, f32, on_cuda

def check_staging(T: int, W: int, n_obs: int) -> None:
    """Raise unless the bicycle kernels can stage u, a (T, 2 each), the
    (W, 4) window, the outline's points and the (n, 3) obstacles in shared
    memory."""
    common.check_staging("bicycle", 4 * T + 4 * W + 2 * OUTLINE_POINTS + 3 * n_obs,
                         f"u, a, the (W={W}, 4) window and {n_obs} obstacles")


def vehicle_scalars(wheel_base=2.5, vehicle_length=4.0, vehicle_width=3.0, margin_rate=1.5,
                    penalty=1.0e7) -> dict:
    """The float32 vehicle constants of both kernels, packed as the JAX
    kernels pack them: 1/L, the margin-scaled half extents and the penalty."""
    return dict(
        inv_wheel_base=f32(1.0 / wheel_base),
        half_l=f32(0.5 * vehicle_length * margin_rate),
        half_w=f32(0.5 * vehicle_width * margin_rate),
        penalty=f32(penalty),
    )


def _bicycle_cost_plain(x, y, yaw, v, c, s, w, window, obstacles, veh, iso_xy):
    """Stage cost of each sample at (x, y, yaw, v) with sin/cos (s, c) of
    yaw; the plain twin of ``dmm_bicycle_cost``. The row is the kernel's
    running min with the first-strict-< rule (``common.running_min_index``)."""
    dx = x[:, None] - window[:, 0]
    dy = y[:, None] - window[:, 1]
    d = dx * dx + dy * dy  # (K, W)
    j = common.running_min_index(d)
    ref = window.index_select(0, j)  # (K, 4)
    # a tensor divisor: PyTorch turns division by a Python scalar into a
    # multiplication by its reciprocal on the card, which can round otherwise
    yaw_w = yaw - TWO_PI * torch.floor(yaw / torch.full_like(yaw, TWO_PI))
    eyaw = yaw_w - ref[:, 2]
    ev = v - ref[:, 3]
    if iso_xy:
        dmin = d.gather(1, j[:, None])[:, 0]
        cost = w[0] * dmin + w[2] * eyaw * eyaw + w[3] * ev * ev
    else:
        ex = x - ref[:, 0]
        ey = y - ref[:, 1]
        cost = w[0] * ex * ex + w[1] * ey * ey + w[2] * eyaw * eyaw + w[3] * ev * ev
    if obstacles is not None and obstacles.shape[0]:
        hit = torch.zeros_like(x)
        for ox, oy in zip(VEHICLE_OUTLINE_X, VEHICLE_OUTLINE_Y):
            bx = f32(f32(ox) * veh["half_l"])
            by = f32(f32(oy) * veh["half_w"])
            px = bx * c - by * s + x
            py = bx * s + by * c + y
            for o in range(obstacles.shape[0]):
                dxo = px - obstacles[o, 0]
                dyo = py - obstacles[o, 1]
                r = obstacles[o, 2]
                hit = torch.where(dxo * dxo + dyo * dyo < r * r, torch.ones_like(hit), hit)
        cost = cost + hit * veh["penalty"]
    return cost


def bicycle_rollout_body_plain(
    eps: torch.Tensor,  # (K, T, 2)
    u: torch.Tensor,
    a: torch.Tensor,
    x0: torch.Tensor,
    window: torch.Tensor,
    stage_w: torch.Tensor,
    term_w: torch.Tensor,
    u_min: torch.Tensor,
    u_max: torch.Tensor,
    *,
    dt: float,
    n_exploit: float,
    vehicle: dict,
    k_offset: float = 0.0,
    obstacles: Optional[torch.Tensor] = None,  # (n, 3)
    iso_xy: bool = False,
) -> torch.Tensor:
    """Per-sample costs S (K,) — the plain twin of ``dmm_bicycle_sample``
    in csrc/bicycle_rollout.cuh (same operations in the same order; the
    sin/cos of the post-step yaw are carried into the next step)."""
    K, T, _ = eps.shape
    dt, inv_L = f32(dt), vehicle["inv_wheel_base"]
    k_idx = torch.arange(K, dtype=torch.float32, device=eps.device) + f32(k_offset)
    exploit = k_idx < f32(n_exploit)
    x, y, yaw, v = (x0[i].expand(K) for i in range(4))
    s, c = torch.sin(yaw), torch.cos(yaw)
    S = torch.zeros(K, dtype=torch.float32, device=eps.device)
    for t in range(T):
        e0, e1 = eps[:, t, 0], eps[:, t, 1]
        st = torch.clamp(torch.where(exploit, u[t, 0] + e0, e0), u_min[0], u_max[0])
        ac = torch.clamp(torch.where(exploit, u[t, 1] + e1, e1), u_min[1], u_max[1])
        x = x + v * c * dt
        y = y + v * s * dt
        yaw = yaw + v * inv_L * torch.tan(st) * dt
        v = v + ac * dt
        s, c = torch.sin(yaw), torch.cos(yaw)
        cost = _bicycle_cost_plain(x, y, yaw, v, c, s, stage_w, window, obstacles, vehicle,
                                   iso_xy)
        cost = cost + a[t, 0] * st + a[t, 1] * ac
        S = S + cost
    return S + _bicycle_cost_plain(x, y, yaw, v, c, s, term_w, window, obstacles, vehicle,
                                   iso_xy)


def launch_bicycle(
    *, u, a, x0, window, stage_w, term_w, u_min, u_max, obstacles, dt, n_exploit,
    vehicle: dict, K: int, T: int, W: int, eps=None, seed=None, chol_sigma=None,
    inv_temperature: float = 0.0, k_offset: float = 0.0, iso_xy: bool = False,
    fused: bool = False,
) -> dict:
    """Check the inputs, allocate the outputs and launch
    ``dmm_bicycle_rollout_costs`` or, with ``fused``, ``dmm_bicycle_tick``.
    Returns a dict of the output tensors; ``eps`` is the (T, K, 2) buffer
    the rollout read or, with hash ε (``eps`` None), wrote."""
    dev = u.device
    n_obs = 0 if obstacles is None else obstacles.shape[0]
    check_staging(T, W, n_obs)
    out = dict(S=torch.empty(K, dtype=torch.float32, device=dev))
    if eps is not None:
        check("eps", eps, (K, T, 2), dev)
        out["eps"] = eps.transpose(0, 1).contiguous()  # (T, K, 2): coalesced per step
    else:
        out["eps"] = torch.empty((T, K, 2), dtype=torch.float32, device=dev)
    fields = dict(
        u=check("u", u, (T, 2), dev),
        a=check("a", a, (T, 2), dev),
        x0=check("x0", x0, (4,), dev),
        window=check("window", window, (W, 4), dev),
        stage_w=check("stage_w", stage_w, (4,), dev),
        term_w=check("term_w", term_w, (4,), dev),
        u_min=check("u_min", u_min, (2,), dev),
        u_max=check("u_max", u_max, (2,), dev),
        obstacles=check("obstacles", obstacles, (n_obs, 3), dev),
        eps=out["eps"].data_ptr(),
        S=out["S"].data_ptr(),
        K=K, T=T, W=W, n_obs=n_obs, eps_mode=0 if eps is not None else 1,
        iso_xy=int(iso_xy), dt=f32(dt), n_exploit=f32(n_exploit), k_offset=f32(k_offset),
        inv_temp=f32(inv_temperature), **vehicle,
        outline_x=(ctypes.c_float * OUTLINE_POINTS)(*VEHICLE_OUTLINE_X),
        outline_y=(ctypes.c_float * OUTLINE_POINTS)(*VEHICLE_OUTLINE_Y),
    )
    if fused:
        for name, shape in (("w", (K,)), ("w_eps", (T, 2)), ("stats", (2,))):
            out[name] = torch.empty(shape, dtype=torch.float32, device=dev)
            fields[name] = out[name].data_ptr()
        fields["chol"] = check("chol_sigma", chol_sigma, (2, 2), dev)
        if eps is None:
            fields["seed"] = check_seed(seed, dev)
    launch("dmm_bicycle_tick" if fused else "dmm_bicycle_rollout_costs",
           DmmBicycleArgs(**fields), dev)
    return out


def bicycle_rollout_costs_plain(
    eps, u, a, x0, window, stage_w, term_w, u_min, u_max, dt, n_exploit,
    wheel_base=2.5, vehicle_length=4.0, vehicle_width=3.0, margin_rate=1.5,
    penalty=1.0e7, obstacles=None, k_offset=0.0, *, T: int, W: int,
) -> torch.Tensor:
    """Plain PyTorch version of :func:`bicycle_rollout_costs`."""
    bicycle_rollout_costs_plain.calls += 1
    check_staging(T, W, 0 if obstacles is None else obstacles.shape[0])
    return bicycle_rollout_body_plain(
        eps, u, a, x0, window[:W], stage_w, term_w, u_min, u_max, dt=dt,
        n_exploit=n_exploit, k_offset=k_offset, obstacles=obstacles,
        vehicle=vehicle_scalars(wheel_base, vehicle_length, vehicle_width, margin_rate,
                                penalty),
    )


bicycle_rollout_costs_plain.calls = 0


def bicycle_rollout_costs(
    eps: torch.Tensor,  # (K, T, 2) noise
    u: torch.Tensor,  # (T, 2) nominal (steer, accel)
    a: torch.Tensor,  # (T, 2) γ·u_tᵀΣ⁻¹
    x0: torch.Tensor,  # (4,) (x, y, yaw, v)
    window: torch.Tensor,  # (W, 4) waypoint window (x, y, yaw, v)
    stage_w: torch.Tensor,  # (4,)
    term_w: torch.Tensor,  # (4,)
    u_min: torch.Tensor,  # (2,)
    u_max: torch.Tensor,  # (2,)
    dt: float,
    n_exploit: float,
    wheel_base: float = 2.5,
    vehicle_length: float = 4.0,
    vehicle_width: float = 3.0,
    margin_rate: float = 1.5,
    penalty: float = 1.0e7,
    obstacles: Optional[torch.Tensor] = None,  # (n_obs, 3) circles or None
    k_offset: float = 0.0,
    *,
    T: int,
    W: int,
) -> torch.Tensor:
    """Per-sample costs S (K,) of the split bicycle rollout."""
    if not on_cuda(u, eps=eps, a=a, x0=x0, window=window, obstacles=obstacles):
        return bicycle_rollout_costs_plain(
            eps, u, a, x0, window, stage_w, term_w, u_min, u_max, dt, n_exploit,
            wheel_base, vehicle_length, vehicle_width, margin_rate, penalty, obstacles,
            k_offset, T=T, W=W,
        )
    out = launch_bicycle(
        eps=eps, u=u, a=a, x0=x0, window=window,
        stage_w=stage_w, term_w=term_w, u_min=u_min, u_max=u_max, obstacles=obstacles,
        dt=dt, n_exploit=n_exploit, k_offset=k_offset, K=eps.shape[0], T=T, W=W,
        vehicle=vehicle_scalars(wheel_base, vehicle_length, vehicle_width, margin_rate,
                                penalty),
    )
    bicycle_rollout_costs.launches += 1
    return out["S"]


bicycle_rollout_costs.launches = 0

__all__ = [
    "bicycle_rollout_body_plain",
    "bicycle_rollout_costs",
    "bicycle_rollout_costs_plain",
    "check_staging",
    "launch_bicycle",
    "vehicle_scalars",
]
