"""Natural cubic spline course generation (host-side path preparation).

A copy of ``dnn_mppi_mpc_tpu/paths/splines.py`` (numpy only; the port
imports nothing of the JAX package); ``tests/test_torch_paths.py`` holds
the two copies equal.

Vectorized re-design of path_generator/cubic_spline_planner.py: the reference
builds the tridiagonal system row-by-row in Python (:46-172) and evaluates one
point at a time with ``bisect``; here coefficients come from one banded solve
and evaluation is a vectorized ``searchsorted`` gather. Path preparation runs
once per scenario on the host, so this is numpy; the resulting (P, d) waypoint
tables are then device_put once and consumed by the solvers.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class CubicSpline1D:
    """Natural cubic spline y(x) with zero second derivative at both ends.

    Same spline family as path_generator/cubic_spline_planner.py:46-172
    (coefficients a,b,c,d per segment); construction is one vectorized
    tridiagonal solve instead of a Python loop.
    """

    x: np.ndarray
    a: np.ndarray
    b: np.ndarray
    c: np.ndarray
    d: np.ndarray

    @classmethod
    def fit(cls, x: np.ndarray, y: np.ndarray) -> "CubicSpline1D":
        x = np.asarray(x, dtype=np.float64)
        y = np.asarray(y, dtype=np.float64)
        h = np.diff(x)
        if np.any(h < 0):
            raise ValueError("spline knots x must be strictly increasing")
        n = len(x)
        A = np.zeros((n, n))
        B = np.zeros(n)
        A[0, 0] = 1.0
        A[n - 1, n - 1] = 1.0
        for i in range(1, n - 1):
            A[i, i - 1] = h[i - 1]
            A[i, i] = 2.0 * (h[i - 1] + h[i])
            A[i, i + 1] = h[i]
            B[i] = 3.0 * (y[i + 1] - y[i]) / h[i] - 3.0 * (y[i] - y[i - 1]) / h[i - 1]
        c = np.linalg.solve(A, B)
        a = y.copy()
        b = (a[1:] - a[:-1]) / h - h / 3.0 * (2.0 * c[:-1] + c[1:])
        d = (c[1:] - c[:-1]) / (3.0 * h)
        return cls(x=x, a=a, b=b, c=c, d=d)

    def _segment(self, xq: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        i = np.clip(np.searchsorted(self.x, xq, side="right") - 1, 0, len(self.x) - 2)
        return i, xq - self.x[i]

    def position(self, xq: np.ndarray) -> np.ndarray:
        i, dx = self._segment(np.asarray(xq, dtype=np.float64))
        return self.a[i] + self.b[i] * dx + self.c[i] * dx**2 + self.d[i] * dx**3

    def first_derivative(self, xq: np.ndarray) -> np.ndarray:
        i, dx = self._segment(np.asarray(xq, dtype=np.float64))
        return self.b[i] + 2.0 * self.c[i] * dx + 3.0 * self.d[i] * dx**2

    def second_derivative(self, xq: np.ndarray) -> np.ndarray:
        i, dx = self._segment(np.asarray(xq, dtype=np.float64))
        return 2.0 * self.c[i] + 6.0 * self.d[i] * dx


@dataclasses.dataclass
class CubicSpline2D:
    """Arc-length parameterized 2-D spline (cubic_spline_planner.py:174-309)."""

    s: np.ndarray
    sx: CubicSpline1D
    sy: CubicSpline1D

    @classmethod
    def fit(cls, x: np.ndarray, y: np.ndarray) -> "CubicSpline2D":
        dx = np.diff(np.asarray(x, dtype=np.float64))
        dy = np.diff(np.asarray(y, dtype=np.float64))
        ds = np.hypot(dx, dy)
        s = np.concatenate([[0.0], np.cumsum(ds)])
        return cls(s=s, sx=CubicSpline1D.fit(s, x), sy=CubicSpline1D.fit(s, y))

    def position(self, sq: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        return self.sx.position(sq), self.sy.position(sq)

    def yaw(self, sq: np.ndarray) -> np.ndarray:
        return np.arctan2(self.sy.first_derivative(sq), self.sx.first_derivative(sq))

    def curvature(self, sq: np.ndarray) -> np.ndarray:
        dx = self.sx.first_derivative(sq)
        dy = self.sy.first_derivative(sq)
        ddx = self.sx.second_derivative(sq)
        ddy = self.sy.second_derivative(sq)
        return (ddy * dx - ddx * dy) / ((dx**2 + dy**2) ** 1.5)


def calc_spline_course(
    x: np.ndarray, y: np.ndarray, ds: float = 0.1
) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Sample a 2-D spline course at spacing ``ds`` — the public entry point of
    path_generator/cubic_spline_planner.py:311-324. Returns (rx, ry, ryaw, rk, s)."""
    sp = CubicSpline2D.fit(x, y)
    s = np.arange(0.0, sp.s[-1], ds)
    rx, ry = sp.position(s)
    return rx, ry, sp.yaw(s), sp.curvature(s), s


__all__ = ["CubicSpline1D", "CubicSpline2D", "calc_spline_course"]
