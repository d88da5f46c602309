"""Deterministic token data pipeline with traced, resumable file reads
(the JAX package's ``data/pipeline.py``, NumPy and the port's traced
``posix`` facade; it imports neither JAX nor the JAX package).

Two tiers:

  * ``synthetic_batch(cfg, step, rank)`` -- pure-function batches (no I/O),
    deterministic in (seed, step, rank); used by trainer unit tests and the
    quickstart example.
  * ``TokenFileDataset`` -- a binary token corpus on disk, read through the
    traced POSIX facade with per-host strided offsets:

        offset(step, rank) = (step * nranks + rank) * batch_bytes  (mod file)

    i.e. rank-linear *and* step-linear -- precisely the access pattern the
    paper's intra-/inter-process recognition compresses to O(1) (Section 3.2).

Resumability: the dataset is stateless given ``step``; the trainer persists
only the step counter in its checkpoint metadata.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Dict, Optional

import numpy as np

from ..core.apis import posix


@dataclass(frozen=True)
class SyntheticConfig:
    vocab_size: int = 1024
    seq_len: int = 128
    batch_size: int = 8          # per-host batch
    seed: int = 0


def synthetic_batch(cfg: SyntheticConfig, step: int, rank: int = 0
                    ) -> Dict[str, np.ndarray]:
    """Markov-ish deterministic tokens: next = (3*prev + pos + mix) % V.
    Learnable structure so short training runs show a falling loss."""
    rs = np.random.RandomState((cfg.seed * 9176 + step) * 131 + rank)
    B, S, V = cfg.batch_size, cfg.seq_len, cfg.vocab_size
    first = rs.randint(0, V, size=(B, 1))
    toks = np.empty((B, S + 1), np.int64)
    toks[:, :1] = first
    mix = rs.randint(0, 7, size=(B, 1))
    for t in range(1, S + 1):
        toks[:, t] = (3 * toks[:, t - 1] + t + mix[:, 0]) % V
    return {"tokens": toks[:, :-1].astype(np.int32),
            "labels": toks[:, 1:].astype(np.int32)}


def write_corpus(path: str, n_tokens: int, vocab: int, seed: int = 0) -> None:
    """Materialize a synthetic corpus file (uint32 tokens) via the traced
    facade, in 1 MiB strided writes."""
    rs = np.random.RandomState(seed)
    fd = posix.open(path, os.O_RDWR | os.O_CREAT, 0o644)
    chunk = 1 << 18  # tokens per write
    off = 0
    left = n_tokens
    while left > 0:
        n = min(chunk, left)
        buf = rs.randint(0, vocab, size=n).astype("<u4").tobytes()
        posix.pwrite(fd, buf, off)
        off += len(buf)
        left -= n
    posix.fsync(fd)
    posix.close(fd)


class TokenFileDataset:
    """Strided reader over a token corpus file (traced pread per batch)."""

    def __init__(self, path: str, seq_len: int, batch_size: int,
                 rank: int = 0, nranks: int = 1, vocab: Optional[int] = None):
        self.path = path
        self.seq_len = seq_len
        self.batch_size = batch_size
        self.rank = rank
        self.nranks = nranks
        self.vocab = vocab
        self._fd = posix.open(path, os.O_RDONLY, 0o644)
        self._file_bytes = posix.stat(path)
        self.batch_bytes = 4 * batch_size * (seq_len + 1)
        if self._file_bytes < self.batch_bytes:
            raise ValueError("corpus smaller than one batch")

    def batch(self, step: int) -> Dict[str, np.ndarray]:
        """Deterministic batch for (step, rank); wraps around the file."""
        idx = step * self.nranks + self.rank
        max_start = self._file_bytes - self.batch_bytes
        off = (idx * self.batch_bytes) % (max_start + 1)
        off -= off % 4
        raw = posix.pread(self._fd, self.batch_bytes, off)
        toks = np.frombuffer(raw, dtype="<u4").astype(np.int64)
        toks = toks.reshape(self.batch_size, self.seq_len + 1)
        if self.vocab:
            toks = toks % self.vocab
        return {"tokens": toks[:, :-1].astype(np.int32),
                "labels": toks[:, 1:].astype(np.int32)}

    def close(self) -> None:
        posix.close(self._fd)
