"""Bezier path generation (host-side path preparation).

A copy of ``dnn_mppi_mpc_tpu/paths/bezier.py`` (numpy only; the port
imports nothing of the JAX package); ``tests/test_torch_paths.py`` holds
the two copies equal. The (P, d) tables go to the device through
``config.params_from_numpy``.

Vectorized re-design of path_generator/bezierPath.py: the reference evaluates
one Bernstein term per Python loop iteration (:33-69); here the whole curve is
one (n_points, n_ctrl) Bernstein matrix product.
"""

from __future__ import annotations

import math

import numpy as np


def bernstein_matrix(degree: int, t: np.ndarray) -> np.ndarray:
    """(len(t), degree+1) matrix of Bernstein basis values B_{i,n}(t)
    (path_generator/bezierPath.py:48-58)."""
    i = np.arange(degree + 1)
    comb = np.array([math.comb(degree, k) for k in i], dtype=np.float64)
    t = np.asarray(t, dtype=np.float64)[:, None]
    return comb * t**i * (1.0 - t) ** (degree - i)


def calc_bezier_path(control_points: np.ndarray, n_points: int = 50) -> np.ndarray:
    """Sample a Bezier curve at n_points uniform t (bezierPath.py:33-45)."""
    control_points = np.asarray(control_points, dtype=np.float64)
    t = np.linspace(0.0, 1.0, n_points)
    return bernstein_matrix(len(control_points) - 1, t) @ control_points


def calc_4points_bezier_path(
    sx: float, sy: float, syaw: float, ex: float, ey: float, eyaw: float, offset: float,
    n_points: int = 500,
) -> tuple[np.ndarray, np.ndarray]:
    """4-control-point Bezier from start/end pose (bezierPath.py:8-30):
    interior control points extend along the start/end headings by dist/offset."""
    dist = np.hypot(sx - ex, sy - ey) / offset
    control_points = np.array(
        [
            [sx, sy],
            [sx + dist * np.cos(syaw), sy + dist * np.sin(syaw)],
            [ex - dist * np.cos(eyaw), ey - dist * np.sin(eyaw)],
            [ex, ey],
        ]
    )
    return calc_bezier_path(control_points, n_points=n_points), control_points


def bezier_derivative_control_points(
    control_points: np.ndarray, n_derivatives: int
) -> dict[int, np.ndarray]:
    """Control points of successive derivative curves (bezierPath.py:72-92)."""
    w = {0: np.asarray(control_points, dtype=np.float64)}
    for i in range(n_derivatives):
        n = len(w[i])
        w[i + 1] = (n - 1) * (w[i][1:] - w[i][:-1])
    return w


def curvature(dx, dy, ddx, ddy):
    """Signed curvature from first/second derivatives (bezierPath.py:95-105)."""
    return (dx * ddy - dy * ddx) / (dx**2 + dy**2) ** 1.5


def bezier_course_with_yaw(control_points: np.ndarray, n_points: int = 100) -> np.ndarray:
    """(n_points, 3) course (x, y, yaw) with yaw from the derivative curve —
    the waypoint-table format consumed by the MPPI tracking costs."""
    path = calc_bezier_path(control_points, n_points)
    d = bezier_derivative_control_points(control_points, 1)[1]
    t = np.linspace(0.0, 1.0, n_points)
    deriv = bernstein_matrix(len(d) - 1, t) @ d
    yaw = np.arctan2(deriv[:, 1], deriv[:, 0])
    return np.column_stack([path, yaw])


__all__ = [
    "bernstein_matrix",
    "calc_bezier_path",
    "calc_4points_bezier_path",
    "bezier_derivative_control_points",
    "curvature",
    "bezier_course_with_yaw",
]
