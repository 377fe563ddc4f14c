"""Control-sequence smoothing filters as one (T, T) matrix each.

Counterpart of ``dnn_mppi_mpc_tpu/ops/filters.py``. Every filter is linear
in the sequence, so ``filter(x) == F @ x`` with F built once on the host in
float64 numpy (:func:`filter_matrix`, same construction as the JAX
package's); :func:`apply_filter` is then one float32 matmul with TF32 off.
"""

from __future__ import annotations

import math
from functools import lru_cache

import numpy as np
import torch

from ..config import SmoothingFilter


def savgol_coefficients(window_size: int, polyorder: int) -> np.ndarray:
    """Center-point Savitzky-Golay smoothing coefficients."""
    half = (window_size - 1) // 2
    j = np.arange(-half, half + 1, dtype=np.float64)
    b = np.stack([j**i for i in range(polyorder + 1)], axis=1)
    return np.linalg.pinv(b)[0]


@lru_cache(maxsize=None)
def filter_matrix(kind_value: str, T: int, window: int, polyorder: int = 3) -> np.ndarray:
    """The (T, T) float64 matrix F of a smoothing filter (do not mutate: it
    is cached)."""
    kind = SmoothingFilter(kind_value)
    eye = np.eye(T, dtype=np.float64)

    def conv_same_cols(x, kernel):
        return np.stack(
            [np.convolve(x[:, j], kernel, mode="same") for j in range(x.shape[1])],
            axis=1,
        )

    if kind == SmoothingFilter.NONE:
        return eye
    if kind == SmoothingFilter.MOVING_AVERAGE_EDGE:
        # np.convolve 'same' plus the reference's edge rescaling, including
        # its quirk: the last row's scale is a cumulative product
        w = min(window, T)
        out = conv_same_cols(eye, np.ones(w) / w)
        n_conv = math.ceil(w / 2)
        scale = np.ones((T,), dtype=np.float64)
        scale[0] = w / n_conv
        last = 1.0
        for i in range(1, n_conv):
            scale[i] = w / (i + n_conv)
            last *= w / (i + n_conv - (w % 2))
        scale[-1] *= last
        return out * scale[:, None]
    if kind == SmoothingFilter.MOVING_AVERAGE_PADDED:
        w = min(window, T)
        if w <= 1:
            return eye
        padded = np.concatenate([eye[: w // 2], eye, eye[-(w // 2):]], axis=0)
        out = conv_same_cols(padded, np.ones(w) / w)
        return out[w // 2 : -(w // 2)]
    # SAVGOL with polynomial edge interpolation (scipy mode='interp')
    w = min(window, T)
    if w % 2 == 0:
        w -= 1
    p = min(polyorder, w - 1)
    if w <= 1:
        return eye
    half = (w - 1) // 2
    out = conv_same_cols(eye, savgol_coefficients(w, p)[::-1])
    j = np.arange(w, dtype=np.float64)
    pinv = np.linalg.pinv(np.stack([j**i for i in range(p + 1)], axis=1))
    head_eval = np.stack([np.arange(half) ** i for i in range(p + 1)], axis=1)
    tail_pos = np.arange(w - half, w, dtype=np.float64)
    tail_eval = np.stack([tail_pos**i for i in range(p + 1)], axis=1)
    out[:half] = (head_eval @ pinv) @ eye[:w]
    out[T - half :] = (tail_eval @ pinv) @ eye[-w:]
    return out


def matmul_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` in full float32: TF32 is switched off for this one call on
    the card and restored afterwards."""
    if not a.is_cuda:
        return a @ b
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        return a @ b
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


@lru_cache(maxsize=64)
def filter_tensor(kind_value: str, T: int, window: int, polyorder: int, dtype, device) -> torch.Tensor:
    """:func:`filter_matrix` as a tensor on ``device``, copied there once (a
    host→device copy synchronizes the stream; do not mutate the result)."""
    return torch.as_tensor(filter_matrix(kind_value, T, window, polyorder), dtype=dtype).to(device)


def apply_filter(x: torch.Tensor, kind, window: int, polyorder: int = 3) -> torch.Tensor:
    """Smooth the (T, d) sequence ``x`` along axis 0."""
    kind = SmoothingFilter(kind)
    if kind == SmoothingFilter.NONE:
        return x
    F = filter_tensor(kind.value, x.shape[0], window, polyorder, x.dtype, x.device)
    return matmul_f32(F, x)


__all__ = ["filter_matrix", "filter_tensor", "savgol_coefficients", "apply_filter", "matmul_f32"]
