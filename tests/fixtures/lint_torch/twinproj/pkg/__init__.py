from .ops import packaged

__all__ = ["packaged"]
