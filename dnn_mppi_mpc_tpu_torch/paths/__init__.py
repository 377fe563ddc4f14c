from .generators import circle_with_speed, lemniscate_with_speed, line

__all__ = ["circle_with_speed", "lemniscate_with_speed", "line"]
