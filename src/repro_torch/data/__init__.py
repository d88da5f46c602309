from .pipeline import (SyntheticConfig, TokenFileDataset, synthetic_batch,
                       write_corpus)

__all__ = ["SyntheticConfig", "TokenFileDataset", "synthetic_batch",
           "write_corpus"]
