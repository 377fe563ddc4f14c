"""Windowed nearest-waypoint lookup (counterpart of
``dnn_mppi_mpc_tpu/ops/waypoints.py``; the per-rollout carried variant is
still to be ported).

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


__all__ = ["nearest_waypoint", "waypoint_window"]
