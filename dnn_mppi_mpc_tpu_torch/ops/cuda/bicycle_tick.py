"""Fused race-car MPPI tick: ε, bicycle rollout, softmax and Σw·ε.

Counterpart of ``dnn_mppi_mpc_tpu/ops/pallas/bicycle_tick.py:267
bicycle_mppi_tick``. On CUDA tensors :func:`bicycle_mppi_tick` launches
``dmm_bicycle_tick`` (csrc/bicycle_kernels.cu: the bicycle rollout, then the
diff-drive tick's softmax and Σw·ε reductions); on CPU tensors it runs
:func:`bicycle_mppi_tick_plain`. Like the JAX kernel it returns
``(S, w, w_eps)``: the filter, update, non-finite hold and shift stay in the
solver's tick tail.

Noise: ε is injected (K, T, 2), or drawn from the hash stream of
``ops/cuda/mathx.py`` as one block of K samples — the stream of the
diff-drive fused tick. The TPU's hardware Gaussians have no counterpart here.
"""

from __future__ import annotations

from typing import Optional

import torch

from .common import on_cuda, softmax_plain, weighted_noise_plain
from .mathx import hash_noise
from .rollout_bicycle import (
    bicycle_rollout_body_plain,
    check_staging,
    launch_bicycle,
    vehicle_scalars,
)


def bicycle_mppi_tick_plain(
    seed, u, a, chol_sigma, x0, window, stage_w, term_w, u_min, u_max, dt,
    n_exploit, inv_temperature, obstacles=None, wheel_base=2.5, vehicle_length=4.0,
    vehicle_width=3.0, margin_rate=1.5, penalty=1.0e7, eps=None, *, K: int, T: int,
    W: int, emit_eps: bool = False, iso_xy: bool = False,
):
    """Plain PyTorch version of :func:`bicycle_mppi_tick`."""
    bicycle_mppi_tick_plain.calls += 1
    check_staging(T, W, 0 if obstacles is None else obstacles.shape[0])
    if eps is None:
        eps = hash_noise(seed, chol_sigma, K, T, K)
    S = bicycle_rollout_body_plain(
        eps, u, a, x0, window, stage_w, term_w, u_min, u_max, dt=dt, n_exploit=n_exploit,
        obstacles=obstacles, iso_xy=iso_xy,
        vehicle=vehicle_scalars(wheel_base, vehicle_length, vehicle_width, margin_rate,
                                penalty),
    )
    _, _, w = softmax_plain(S, inv_temperature)
    out = (S, w, weighted_noise_plain(w, eps))
    return out + (eps,) if emit_eps else out


bicycle_mppi_tick_plain.calls = 0


def bicycle_mppi_tick(
    seed: Optional[torch.Tensor],  # (1,) int64 holding the uint32 seed; unused with eps
    u: torch.Tensor,  # (T, 2) nominal (steer, accel)
    a: torch.Tensor,  # (T, 2) γ·u_tᵀΣ⁻¹
    chol_sigma: torch.Tensor,  # (2, 2) lower Cholesky factor of Σ
    x0: torch.Tensor,  # (4,) (x, y, yaw, v)
    window: torch.Tensor,  # (W, 4) waypoint window (x, y, yaw, v)
    stage_w: torch.Tensor,  # (4,)
    term_w: torch.Tensor,  # (4,)
    u_min: torch.Tensor,  # (2,)
    u_max: torch.Tensor,  # (2,)
    dt: float,
    n_exploit: float,
    inv_temperature: float,
    obstacles: Optional[torch.Tensor] = None,  # (n_obs, 3) circles or None
    wheel_base: float = 2.5,
    vehicle_length: float = 4.0,
    vehicle_width: float = 3.0,
    margin_rate: float = 1.5,
    penalty: float = 1.0e7,
    eps: Optional[torch.Tensor] = None,  # (K, T, 2) injected ε
    *,
    K: int,
    T: int,
    W: int,
    emit_eps: bool = False,
    iso_xy: bool = False,
):
    """One fused race-car MPPI tick → ``(S (K,), w (K,), w_eps (T, 2))``,
    plus the ε used (K, T, 2) when ``emit_eps``.

    ``iso_xy`` specializes the cost for symmetric x/y tracking weights
    (w0·d²min + w2·Δyaw² + w3·Δv²); the caller guarantees the symmetry."""
    if eps is None and K % 128:
        raise ValueError(f"generated ε needs K a multiple of 128, got K={K}")
    if not on_cuda(u, eps=eps, seed=seed, window=window, x0=x0, obstacles=obstacles):
        return bicycle_mppi_tick_plain(
            seed, u, a, chol_sigma, x0, window, stage_w, term_w, u_min, u_max, dt,
            n_exploit, inv_temperature, obstacles, wheel_base, vehicle_length,
            vehicle_width, margin_rate, penalty, eps, K=K, T=T, W=W, emit_eps=emit_eps,
            iso_xy=iso_xy,
        )
    out = launch_bicycle(
        fused=True, seed=seed, eps=eps, chol_sigma=chol_sigma, u=u,
        a=a, x0=x0, window=window, stage_w=stage_w, term_w=term_w, u_min=u_min,
        u_max=u_max, obstacles=obstacles, dt=dt, n_exploit=n_exploit,
        inv_temperature=inv_temperature, iso_xy=iso_xy, K=K, T=T, W=W,
        vehicle=vehicle_scalars(wheel_base, vehicle_length, vehicle_width, margin_rate,
                                penalty),
    )
    bicycle_mppi_tick.launches += 1
    result = (out["S"], out["w"], out["w_eps"])
    if emit_eps:
        result += (eps if eps is not None else out["eps"].transpose(0, 1),)
    return result


bicycle_mppi_tick.launches = 0

__all__ = ["bicycle_mppi_tick", "bicycle_mppi_tick_plain"]
