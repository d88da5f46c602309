from .ops import digram_counts, row_boundaries, row_run_starts

__all__ = ["digram_counts", "row_boundaries", "row_run_starts"]
