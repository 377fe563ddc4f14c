from .bezier import bezier_course_with_yaw, calc_4points_bezier_path, calc_bezier_path
from .generators import circle_with_speed, lemniscate, lemniscate_with_speed, line
from .splines import CubicSpline1D, CubicSpline2D, calc_spline_course

__all__ = [
    "CubicSpline1D",
    "CubicSpline2D",
    "bezier_course_with_yaw",
    "calc_4points_bezier_path",
    "calc_bezier_path",
    "calc_spline_course",
    "circle_with_speed",
    "lemniscate",
    "lemniscate_with_speed",
    "line",
]
