from .generators import line

__all__ = ["line"]
