"""Control-sequence smoothing filters as one (T, T) matrix each.

Counterpart of ``dnn_mppi_mpc_tpu/ops/filters.py``. Every filter is linear
in the sequence, so ``filter(x) == F @ x`` with F built once on the host in
float64 numpy (:func:`filter_matrix`, same construction as the JAX
package's); :func:`apply_filter` is then one float32 matmul with TF32 off.
The JAX package's public helpers :func:`moving_average_edge`,
:func:`moving_average_padded` and :func:`savgol_filter` are that one
product on a (T, d) sequence.
"""

from __future__ import annotations

import contextlib
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


@contextlib.contextmanager
def full_f32():
    """Inside the block, float32 matrix products (cuBLAS) and convolutions
    (cuDNN) on the card run in full float32, not TF32; both flags are
    restored afterwards."""
    prev = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev


def matmul_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` in full float32: TF32 is switched off for this one call on
    the card and restored afterwards."""
    if not a.is_cuda:
        return a @ b
    with full_f32():
        return a @ b


@lru_cache(maxsize=64)
def filter_tensor(kind_value: str, T: int, window: int, polyorder: int, dtype, device) -> torch.Tensor:
    """:func:`filter_matrix` as a tensor on ``device``, copied there once (a
    host→device copy synchronizes the stream; do not mutate the result)."""
    return torch.as_tensor(filter_matrix(kind_value, T, window, polyorder), dtype=dtype).to(device)


def apply_filter(x: torch.Tensor, kind, window: int, polyorder: int = 3) -> torch.Tensor:
    """Smooth the (..., T, d) sequences ``x`` along their T axis."""
    kind = SmoothingFilter(kind)
    if kind == SmoothingFilter.NONE:
        return x
    F = filter_tensor(kind.value, x.shape[-2], window, polyorder, x.dtype, x.device)
    return matmul_f32(F, x)


def moving_average_edge(x: torch.Tensor, window_size: int) -> torch.Tensor:
    """Moving average with the reference's edge rescaling, along axis 0."""
    return apply_filter(x, SmoothingFilter.MOVING_AVERAGE_EDGE, window_size)


def moving_average_padded(x: torch.Tensor, window_size: int) -> torch.Tensor:
    """Head/tail-slice padded moving average, along axis 0."""
    return apply_filter(x, SmoothingFilter.MOVING_AVERAGE_PADDED, window_size)


def savgol_filter(x: torch.Tensor, window_size: int, polyorder: int) -> torch.Tensor:
    """Savitzky-Golay smoothing along axis 0 with scipy's ``mode='interp'``
    edges; the window is clamped to T and made odd, the order below it."""
    return apply_filter(x, SmoothingFilter.SAVGOL, window_size, polyorder)


__all__ = ["apply_filter", "filter_matrix", "filter_tensor", "full_f32", "matmul_f32",
           "moving_average_edge", "moving_average_padded", "savgol_coefficients",
           "savgol_filter"]
