from .ops import row_boundaries

__all__ = ["row_boundaries"]
