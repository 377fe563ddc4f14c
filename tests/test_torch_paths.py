"""The port's vendored Bezier and spline path preparation against the JAX
package's copies, on the CPU: numpy on both sides, so every result is
bit-equal; and tests/test_paths.py's properties on the port's copy (scipy's
natural cubic spline, the circle's curvature, the course spacing, Bezier
end points and headings), the tables put on the device through
``params_from_numpy``."""

from __future__ import annotations

import numpy as np
import pytest
import torch
from scipy.interpolate import CubicSpline as ScipyCubic

from dnn_mppi_mpc_tpu.paths import bezier as jbez
from dnn_mppi_mpc_tpu.paths import splines as jspl
from dnn_mppi_mpc_tpu_torch import paths as tpaths
from dnn_mppi_mpc_tpu_torch.config import params_from_numpy
from dnn_mppi_mpc_tpu_torch.paths import bezier as tbez
from dnn_mppi_mpc_tpu_torch.paths import splines as tspl

CP = np.array([[0.0, 0.0], [1.5, 2.0], [3.0, -1.0], [5.0, 1.0], [6.0, 0.5]])


def _equal(a, b):
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _equal(a[k], b[k])
    elif isinstance(a, tuple):
        for x, y in zip(a, b):
            _equal(x, y)
    else:
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


BEZIER_CALLS = {
    "bernstein_matrix": lambda m: m.bernstein_matrix(4, np.linspace(0, 1, 33)),
    "calc_bezier_path": lambda m: m.calc_bezier_path(CP, 57),
    "calc_4points_bezier_path": lambda m: m.calc_4points_bezier_path(
        0.0, 0.0, 0.3, 5.0, 3.0, np.pi / 2, 3.0, n_points=101),
    "bezier_derivative_control_points": lambda m: m.bezier_derivative_control_points(CP, 3),
    "curvature": lambda m: m.curvature(np.array([1.0, 0.5]), np.array([0.2, 1.0]),
                                       np.array([0.0, -0.3]), np.array([0.4, 0.1])),
    "bezier_course_with_yaw": lambda m: m.bezier_course_with_yaw(CP, 80),
}


@pytest.mark.parametrize("name", list(BEZIER_CALLS))
def test_bezier_bit_equal_to_jax(name):
    _equal(BEZIER_CALLS[name](tbez), BEZIER_CALLS[name](jbez))


def test_splines_bit_equal_to_jax():
    x = np.array([0.0, 1.0, 2.5, 3.0, 5.0, 7.0])
    y = np.array([1.7, -6.0, 5.0, 6.5, 0.0, 2.0])
    xq = np.linspace(-0.5, 7.5, 211)
    a, b = tspl.CubicSpline1D.fit(x, y), jspl.CubicSpline1D.fit(x, y)
    for f in ("position", "first_derivative", "second_derivative"):
        _equal(getattr(a, f)(xq), getattr(b, f)(xq))
    t = np.linspace(0, 2 * np.pi, 60)
    a2, b2 = tspl.CubicSpline2D.fit(3 * np.cos(t), 2 * np.sin(t)), jspl.CubicSpline2D.fit(
        3 * np.cos(t), 2 * np.sin(t))
    s = np.linspace(0.0, a2.s[-1], 97)
    for f in ("position", "yaw", "curvature"):
        _equal(getattr(a2, f)(s), getattr(b2, f)(s))
    args = ([0.0, 2.0, 4.0, 6.0, 7.5], [0.0, 1.0, -1.0, 0.0, 2.0])
    _equal(tspl.calc_spline_course(*args, ds=0.05), jspl.calc_spline_course(*args, ds=0.05))
    with pytest.raises(ValueError, match="strictly increasing"):
        tspl.CubicSpline1D.fit([0.0, 2.0, 1.0], [0.0, 1.0, 2.0])


def test_cubic_spline_1d_matches_scipy_natural():
    x = np.array([0.0, 1.0, 2.5, 3.0, 5.0, 7.0])
    y = np.array([1.7, -6.0, 5.0, 6.5, 0.0, 2.0])
    ours, ref = tspl.CubicSpline1D.fit(x, y), ScipyCubic(x, y, bc_type="natural")
    xq = np.linspace(0.0, 7.0, 200)
    np.testing.assert_allclose(ours.position(xq), ref(xq), atol=1e-9)
    np.testing.assert_allclose(ours.first_derivative(xq), ref(xq, 1), atol=1e-9)
    np.testing.assert_allclose(ours.second_derivative(xq), ref(xq, 2), atol=1e-8)


def test_spline_course_on_the_device_as_a_table():
    """A course from the spline goes to the solvers through
    params_from_numpy as a float32 (P, 3) table, and the Bezier course the
    same way."""
    rx, ry, ryaw, rk, s = tpaths.calc_spline_course([0.0, 2.0, 4.0, 6.0],
                                                    [0.0, 1.0, -1.0, 0.0], ds=0.1)
    assert len(rx) == len(ry) == len(ryaw) == len(rk) == len(s)
    np.testing.assert_allclose(np.diff(s), 0.1, atol=1e-12)
    assert np.min(np.hypot(np.asarray(rx) - 2.0, np.asarray(ry) - 1.0)) < 0.06
    for table in (np.stack([rx, ry, ryaw], 1), tpaths.bezier_course_with_yaw(CP, 50)):
        p = params_from_numpy(np.eye(2), np.ones(3), np.ones(3), -np.ones(2), np.ones(2), table,
                              device="cpu")
        assert p.ref_path.dtype == torch.float32 and p.ref_path.shape == table.shape
        np.testing.assert_array_equal(p.ref_path.numpy(), table.astype(np.float32))


def test_bezier_endpoints_and_heading():
    path, cp = tpaths.calc_4points_bezier_path(0.0, 0.0, 0.0, 5.0, 3.0, np.pi / 2, 3.0)
    np.testing.assert_allclose(path[0], [0.0, 0.0], atol=1e-12)
    np.testing.assert_allclose(path[-1], [5.0, 3.0], atol=1e-12)
    np.testing.assert_allclose(tbez.bernstein_matrix(3, np.linspace(0, 1, 50)).sum(1), 1.0,
                               atol=1e-12)
    course = tpaths.bezier_course_with_yaw(cp, 100)
    np.testing.assert_allclose(course[0, 2], 0.0, atol=1e-9)
    np.testing.assert_allclose(course[-1, 2], np.pi / 2, atol=1e-9)
