"""What the kernel modules share on the Python side: the argument checks
before a launch (the shared-memory budget among them), and the diff-drive
plain PyTorch rollout body, softmax and weighted-noise sum that mirror the
CUDA device code operation for operation."""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch


def f32(x: float) -> float:
    """``x`` rounded to float32, the value a kernel receives for it."""
    return float(np.float32(x))


# The rollouts stage their per-tick constants in shared memory under the
# static 48 KB limit (kMaxSmemBytes in csrc/mppi_reductions.cuh).
MAX_SMEM_BYTES = 48 * 1024
# The dynamic shared memory one block may opt into on sm_90 (227 KB): the
# fused MLP's and the ResNet chain's activation buffers.
MAX_SMEM_OPT_IN = 232448
TWO_PI = f32(2.0 * np.pi)


def check_staging(what: str, n_floats: int, staged: str) -> None:
    """Raise unless the ``what`` kernels can stage ``n_floats`` float32
    values (``staged`` names them) in shared memory: the window is never
    cut short."""
    need = 4 * n_floats
    if need > MAX_SMEM_BYTES:
        raise ValueError(
            f"the {what} kernels stage {staged} in {need} bytes of shared memory, over the "
            f"{MAX_SMEM_BYTES}-byte limit: shorten waypoint_search_len or the horizon"
        )


def on_cuda(ref: torch.Tensor, **tensors: Optional[torch.Tensor]) -> bool:
    """True when ``ref`` lies on a CUDA device. Every other given tensor must
    lie on the same device (a mix of CPU and CUDA raises)."""
    for name, t in tensors.items():
        if t is not None and t.device != ref.device:
            raise ValueError(f"{name} is on {t.device}, expected {ref.device}")
    return ref.is_cuda


def check(name: str, t: Optional[torch.Tensor], shape: tuple, device: torch.device) -> int:
    """Raise unless ``t`` is a contiguous float32 tensor of ``shape`` on
    ``device``; return its data pointer (0 for None)."""
    if t is None:
        return 0
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != torch.float32:
        raise ValueError(f"{name} must be float32, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    return t.data_ptr()


def check_seed(seed: torch.Tensor, device: torch.device, n: int = 1) -> int:
    """The tick seed (a fleet's ``n`` seeds): a contiguous int64 tensor of
    ``n`` elements on ``device``."""
    if (seed.device != device or seed.dtype != torch.int64 or seed.numel() != n
            or not seed.is_contiguous()):
        raise ValueError(
            f"seed must be {n} contiguous int64 element(s) on {device}, got "
            f"{seed.dtype} {tuple(seed.shape)} on {seed.device}"
        )
    return seed.data_ptr()


def running_min_index(d: torch.Tensor) -> torch.Tensor:
    """The window row a kernel's running minimum over each row of d (K, W)
    picks: row 0, then a later row only where its d is strictly less. Ties
    go to the first row, a NaN d past row 0 is never picked, and a NaN d at
    row 0 is kept. Written without a host sync."""
    nan = torch.isnan(d)
    j = torch.argmin(torch.where(nan, torch.full_like(d, float("inf")), d), dim=1)
    return torch.where(nan[:, 0], torch.zeros_like(j), j)


def _tracking_plain(x, y, yaw, window, w, iso_xy: bool) -> torch.Tensor:
    """Nearest-waypoint tracking cost of each sample over the (W, 3) window:
    the kernels' running min with the first-strict-< rule (running_min_index)."""
    dx = x[:, None] - window[:, 0]
    dy = y[:, None] - window[:, 1]
    d = dx * dx + dy * dy  # (K, W)
    j = running_min_index(d)
    eyaw = yaw - window[j, 2]
    if iso_xy:
        dmin = d.gather(1, j[:, None])[:, 0]
        return w[0] * dmin + w[2] * eyaw * eyaw
    ex = x - window[j, 0]
    ey = y - window[j, 1]
    return w[0] * ex * ex + w[1] * ey * ey + w[2] * eyaw * eyaw


def carried_rows_plain(x, y, window, idx, span: int):
    """The kernels' carried search (``dmm_carried_row``, waypoint_carry=
    "rollout") for each sample: over the rows idx ≤ i < idx + span of the
    (W, ≥2) window, the first row whose d is strictly below 1e30 and below
    every earlier row's (a NaN d never wins). Returns ``(row, d, found)``:
    row is the sample's idx and d is 1e30 where no row was found. Written
    without a host sync."""
    W = window.shape[0]
    dx = x[:, None] - window[:, 0]
    dy = y[:, None] - window[:, 1]
    d = dx * dx + dy * dy  # (K, W)
    i = torch.arange(W, device=d.device)
    valid = (i >= idx[:, None]) & (i < idx[:, None] + span) & (d < 1.0e30)
    dd = torch.where(valid, d, torch.full_like(d, float("inf")))
    j = torch.argmin(dd, dim=1)  # the first of the least: argmin's tie rule
    dj = dd.gather(1, j[:, None])[:, 0]
    found = dj < 1.0e30
    return (torch.where(found, j, idx), torch.where(found, dj, torch.full_like(dj, 1.0e30)),
            found)


def _tracking_carried_plain(x, y, yaw, window, w, iso_xy: bool, idx, span: int):
    """The plain twin of ``dmm_tracking_carried``: the tracking cost from the
    carried starts idx (K,) and the row found (idx where none was: the
    reference then reads (0, 0, 0) and, iso_xy, d = 1e30)."""
    row, dmin, found = carried_rows_plain(x, y, window, idx, span)
    ref = torch.where(found[:, None], window.index_select(0, row)[:, :3],
                      torch.zeros((), dtype=window.dtype, device=window.device))
    eyaw = yaw - ref[:, 2]
    if iso_xy:
        return w[0] * dmin + w[2] * eyaw * eyaw, row
    ex = x - ref[:, 0]
    ey = y - ref[:, 1]
    return w[0] * ex * ex + w[1] * ey * ey + w[2] * eyaw * eyaw, row


def _obstacle_plain(x, y, obs, obs_mode: str, obs_radius: float, soft_dist: float,
                    soft_w: float, t_f: Optional[float]) -> torch.Tensor:
    """Obstacle cost at rollout time ``t_f`` (None: initial positions) for
    (n, 5) rows (x, y, r, vx, vy)."""
    pen = torch.zeros_like(x)
    for o in range(obs.shape[0]):
        ox, oy = obs[o, 0], obs[o, 1]
        if t_f is not None:
            ox = ox + obs[o, 3] * t_f
            oy = oy + obs[o, 4] * t_f
        dxo = x - ox
        dyo = y - oy
        d2 = dxo * dxo + dyo * dyo
        if obs_mode == "circle":
            rr = obs[o, 2] + obs_radius
            pen = torch.where(d2 < rr * rr, torch.ones_like(pen), pen)
        else:
            d = torch.sqrt(d2 + f32(1e-12))
            pen = pen + torch.where(d < soft_dist, torch.exp(soft_dist - d), torch.zeros_like(d))
    return pen * 1.0e7 if obs_mode == "circle" else pen * soft_w


def rollout_body_plain(
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
    k_offset: float = 0.0,
    obstacles: Optional[torch.Tensor] = None,  # (n, 5) packed rows
    obs_mode: str = "circle",
    obs_radius: float = 0.0,
    drift: bool = False,
    soft_dist: float = 0.0,
    soft_w: float = 0.0,
    control_w: Optional[torch.Tensor] = None,
    iso_xy: bool = False,
    last_only: bool = False,
    carry_W: int = 0,
):
    """Per-sample costs S (K,) — the plain twin of ``dmm_rollout_sample``
    in csrc/diffdrive_rollout.cuh (same operations in the same order). With
    ``carry_W`` > 0 (waypoint_carry="rollout") each sample carries its window
    start from row 0 of ``window`` and searches ``carry_W`` rows from it;
    returns ``(S, final starts (K,) int64)``."""
    if obs_mode not in ("circle", "soft"):
        raise ValueError(f"obs_mode must be 'circle' or 'soft', got {obs_mode!r}")
    K, T, _ = eps.shape
    dt, obs_radius, soft_dist, soft_w = f32(dt), f32(obs_radius), f32(soft_dist), f32(soft_w)
    k_idx = torch.arange(K, dtype=torch.float32, device=eps.device) + f32(k_offset)
    exploit = k_idx < f32(n_exploit)
    x = x0[0].expand(K)
    y = x0[1].expand(K)
    yaw = x0[2].expand(K)
    S = torch.zeros(K, dtype=torch.float32, device=eps.device)
    idx = torch.zeros(K, dtype=torch.int64, device=eps.device)
    n_obs = 0 if obstacles is None else obstacles.shape[0]
    for t in range(T):
        e0, e1 = eps[:, t, 0], eps[:, t, 1]
        v0 = torch.clamp(torch.where(exploit, u[t, 0] + e0, e0), u_min[0], u_max[0])
        v1 = torch.clamp(torch.where(exploit, u[t, 1] + e1, e1), u_min[1], u_max[1])
        s, c = torch.sin(yaw), torch.cos(yaw)
        x = x + v0 * c * dt
        y = y + v0 * s * dt
        yaw = yaw + v1 * dt
        if carry_W:
            cost, idx = _tracking_carried_plain(x, y, yaw, window, stage_w, iso_xy, idx, carry_W)
        else:
            cost = _tracking_plain(x, y, yaw, window, stage_w, iso_xy)
        cost = cost + a[t, 0] * v0 + a[t, 1] * v1
        if control_w is not None:
            cost = cost + control_w[0] * v0 * v0 + control_w[1] * v1 * v1
        if n_obs:
            t_f = float(np.float32(t) * np.float32(dt)) if drift else None
            cost = cost + _obstacle_plain(
                x, y, obstacles, obs_mode, obs_radius, soft_dist, soft_w, t_f
            )
        S = cost if last_only else S + cost
    if carry_W:
        S = S + _tracking_carried_plain(x, y, yaw, window, term_w, iso_xy, idx, carry_W)[0]
    else:
        S = S + _tracking_plain(x, y, yaw, window, term_w, iso_xy)
    if n_obs:
        S = S + _obstacle_plain(x, y, obstacles, obs_mode, obs_radius, soft_dist, soft_w, None)
    return (S, idx) if carry_W else S


def softmax_plain(S: torch.Tensor, inv_temperature: float):
    """(ρ, η, w) with ρ = min S, w = exp(−λ(S−ρ))/η."""
    rho = S.min()
    m = torch.exp(-f32(inv_temperature) * (S - rho))
    eta = m.sum()
    return rho, eta, m / eta


def weighted_noise_plain(w: torch.Tensor, eps: torch.Tensor) -> torch.Tensor:
    """Σₖ wₖ·εₖ over the unclamped ε (K, T, 2) → (T, 2)."""
    return (w[:, None, None] * eps).sum(0)


__all__ = [
    "MAX_SMEM_BYTES",
    "MAX_SMEM_OPT_IN",
    "TWO_PI",
    "check",
    "check_seed",
    "carried_rows_plain",
    "check_staging",
    "f32",
    "on_cuda",
    "rollout_body_plain",
    "running_min_index",
    "softmax_plain",
    "weighted_noise_plain",
]
