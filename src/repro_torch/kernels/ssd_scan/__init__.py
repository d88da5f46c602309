from .ops import ssd_scan

__all__ = ["ssd_scan"]
