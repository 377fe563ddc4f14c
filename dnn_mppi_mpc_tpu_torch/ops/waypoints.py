"""Windowed nearest-waypoint lookup (counterpart of
``dnn_mppi_mpc_tpu/ops/waypoints.py``; the per-rollout carried variant is
still to be ported), for one controller and for a fleet of B.

The window start is a device tensor and the window is a device gather, so a
control tick never waits on the host for it.
"""

from __future__ import annotations

import torch


def waypoint_window(
    ref_path: torch.Tensor, start_idx, search_len: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """The clipped window ``ref_path[start : start + W]`` with
    ``start = clip(start_idx, 0, max(P − W, 0))`` and ``W = min(search_len, P)``.

    Returns ``(start, window)``: a 0-d int64 tensor and the (W, d) rows."""
    P = ref_path.shape[0]
    W = min(search_len, P)
    start = torch.clamp(
        torch.as_tensor(start_idx, dtype=torch.int64, device=ref_path.device),
        0, max(P - W, 0),
    )
    rows = start + torch.arange(W, dtype=torch.int64, device=ref_path.device)
    return start, ref_path.index_select(0, rows)


def nearest_waypoint(
    ref_path: torch.Tensor,
    xy: torch.Tensor,
    start_idx,
    search_len: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Closest waypoint to each query point within the tick's window.

    ``xy`` is (..., 2). Returns ``(idx, ref)``: (...,) int64 global indices
    and the (..., d) waypoint rows. Ties go to the first index (argmin)."""
    start, window = waypoint_window(ref_path, start_idx, search_len)
    d2 = ((xy[..., None, :2] - window[:, :2]) ** 2).sum(-1)
    local = torch.argmin(d2, dim=-1)
    # index_select, not window[local]: a 0-d index tensor would be read on
    # the host, which waits for the card
    ref = window.index_select(0, local.reshape(-1)).reshape(local.shape + window.shape[1:])
    return local + start, ref


def fleet_waypoint_windows(
    ref_path: torch.Tensor, start_idx: torch.Tensor, search_len: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """:func:`waypoint_window` for B members: ``start_idx`` (B,) and a shared
    (P, d) or per-member (B, P, d) path. Returns ``(start (B,), windows
    (B, W, d))``."""
    P = ref_path.shape[-2]
    W = min(search_len, P)
    start = torch.clamp(start_idx.to(torch.int64), 0, max(P - W, 0))
    rows = start[:, None] + torch.arange(W, dtype=torch.int64, device=ref_path.device)
    if ref_path.dim() == 3:
        windows = torch.gather(ref_path, 1, rows[..., None].expand(-1, -1, ref_path.shape[-1]))
    else:
        windows = ref_path.index_select(0, rows.reshape(-1)).reshape(rows.shape + ref_path.shape[1:])
    return start, windows


def fleet_nearest_waypoint(
    ref_path: torch.Tensor, xy: torch.Tensor, start_idx: torch.Tensor, search_len: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """:func:`nearest_waypoint` for B members, one query point each: ``xy``
    (B, 2), ``start_idx`` (B,), a shared (P, d) or per-member (B, P, d)
    path (the vmapped ``advance`` of the JAX fleet step). Returns ``(idx (B,),
    ref (B, d))``."""
    start, windows = fleet_waypoint_windows(ref_path, start_idx, search_len)
    d2 = ((xy[:, None, :2] - windows[..., :2]) ** 2).sum(-1)  # (B, W)
    local = torch.argmin(d2, dim=-1)
    ref = torch.gather(windows, 1, local[:, None, None].expand(-1, 1, windows.shape[-1]))[:, 0]
    return local + start, ref


__all__ = ["fleet_nearest_waypoint", "fleet_waypoint_windows", "nearest_waypoint",
           "waypoint_window"]
