"""Sharded, fault-tolerant checkpoint engine (the JAX package's
``checkpoint/engine.py``).

Every byte flows through the port's traced I/O facades (``core.apis.
shardio`` -> ``core.apis.posix``), so a Recorder session sees the full call
chain with depths, and -- because shard ``r`` of every array lands at
offset ``global_offset + lo(r) * row_bytes`` -- the trace compresses to a
constant size across hosts (the paper's Listing-3 pattern).

Layout of one checkpoint, the JAX package's byte for byte::

    <dir>/step_<N>.tmp/arrays.bin     all arrays, rank-sharded on dim 0
    <dir>/step_<N>.tmp/manifest.json  shapes, dtypes, offsets, crc32 per shard
    -> fsync + rename to <dir>/step_<N>   (atomic commit)

Arrays are named and ordered as ``jax.tree_util.tree_flatten_with_path``
orders a pytree: dict keys sorted, list items by index, the path joined
by ``/``.  A tree holds numpy arrays or torch tensors; a bfloat16 leaf (a
torch tensor, or a numpy array of a dtype named ``bfloat16``) is stored as
its 16-bit patterns and named ``bfloat16`` in the manifest.  A restored
tree holds numpy arrays, and CPU torch tensors for bfloat16 leaves (numpy
has no such dtype, and the port does not import ``ml_dtypes``).

Fault tolerance:
  * atomic tmp+rename commit; readers only ever see complete checkpoints,
  * crc32 per (array, rank-slice), verified on restore,
  * ``latest_step`` skips trailing .tmp debris from crashed writers,
  * elastic restore: offsets are global, so a checkpoint written by N
    hosts restores on M hosts,
  * keep-k garbage collection,
  * async snapshot thread (thread id visible in traces, paper §2.2); the
    host copies it writes are taken before ``save`` returns.
"""

from __future__ import annotations

import json
import os
import threading
import zlib
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..core.apis import posix, shardio
from ..core.comm import Comm, SoloComm
from ..models.convert import reference_leaves, tree_map


def _rebuild(tree, leaves: Dict[str, Any], prefix: str = ""):
    """``tree``'s structure with the leaf at each name from ``leaves``."""
    def name(k):
        return f"{prefix}/{k}" if prefix else str(k)
    if isinstance(tree, dict):
        return {k: _rebuild(v, leaves, name(k)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_rebuild(v, leaves, name(i)) for i, v in enumerate(tree)]
    return leaves[prefix]


def _bytes_view(leaf) -> Tuple[np.ndarray, str]:
    """A host numpy array holding the leaf's bytes, and its dtype name."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
        arr = t.numpy()
        return arr, str(arr.dtype)
    arr = np.asarray(leaf)
    return arr, str(arr.dtype)


def _host_copy(leaf):
    """A snapshot of ``leaf`` that later steps cannot change."""
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().to("cpu", copy=True)
    return np.asarray(leaf)


def _shard_range(n_rows: int, rank: int, nranks: int) -> Tuple[int, int]:
    """Row range of ``rank``'s shard (dim-0 block partitioning; the last
    rank takes the remainder)."""
    per = n_rows // nranks
    lo = rank * per
    hi = n_rows if rank == nranks - 1 else lo + per
    return lo, hi


def manifest_path(d: str) -> str:
    return os.path.join(d, "manifest.json")


def _committed_steps(ckpt_dir: str) -> List[int]:
    steps = []
    for d in os.listdir(ckpt_dir):
        if d.startswith("step_") and not d.endswith(".tmp"):
            try:
                steps.append(int(d.split("_")[1]))
            except ValueError:
                continue
    return sorted(steps)


def save_sharded(tree, ckpt_dir: str, step: int, rank: int = 0,
                 nranks: int = 1, comm: Optional[Comm] = None,
                 meta: Optional[Dict] = None, commit: bool = True) -> str:
    """Write ``rank``'s shards of every array. Rank 0 writes the manifest
    and commits. Returns the final checkpoint directory.

    ``commit=False`` defers the atomic rename (used when simulated ranks
    run sequentially in one process: writers go first, rank 0 commits)."""
    comm = comm or SoloComm()
    tmp = os.path.join(ckpt_dir, f"step_{step:08d}.tmp")
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    if rank == 0 or not os.path.isdir(tmp):
        posix.makedirs(tmp, 0o755)  # idempotent + race-safe across writers
    comm.barrier()
    data_path = os.path.join(tmp, "arrays.bin")
    fh = shardio.shard_open(data_path, 1)

    entries = []
    crcs: Dict[str, int] = {}
    offset = 0
    for name, leaf in reference_leaves(tree):
        arr, dtype = _bytes_view(leaf)
        nbytes = arr.nbytes
        n_rows = arr.shape[0] if arr.ndim else 1
        if arr.ndim >= 1 and n_rows >= nranks:
            lo, hi = _shard_range(n_rows, rank, nranks)
            row_bytes = nbytes // max(n_rows, 1)
            buf = np.ascontiguousarray(arr[lo:hi]).tobytes()
            shardio.shard_write_at(fh, buf, offset + lo * row_bytes)
        elif rank == 0:  # small / scalar arrays: rank 0 writes whole
            buf = arr.tobytes()
            shardio.shard_write_at(fh, buf, offset)
        else:
            buf = b""
        crcs[name] = zlib.crc32(buf)
        entries.append({"name": name, "dtype": dtype,
                        "shape": list(arr.shape), "offset": offset,
                        "nbytes": nbytes})
        offset += nbytes
    shardio.shard_sync(fh)
    shardio.shard_close(fh)

    gathered = comm.gather(crcs)
    if rank == 0:
        manifest = {"step": step, "nranks": nranks, "total_bytes": offset,
                    "arrays": entries,
                    "crcs": {str(r): g for r, g in enumerate(gathered)},
                    "meta": meta or {}}
        mfh = shardio.shard_open(manifest_path(tmp), 1)
        shardio.shard_write_at(mfh, json.dumps(manifest).encode(), 0)
        shardio.shard_sync(mfh)
        shardio.shard_close(mfh)
    comm.barrier()
    if rank == 0 and commit:
        shardio.shard_commit(tmp, final)   # atomic rename
    comm.barrier()
    return final if commit else tmp


def _verify(names, arrays, manifest, ckpt_path: str) -> None:
    """Each writer rank's slice crc against the writer's record."""
    w_ranks = manifest["nranks"]
    for name, arr in zip(names, arrays):
        n_rows = arr.shape[0] if arr.ndim else 1
        if arr.ndim >= 1 and n_rows >= w_ranks:
            for r in range(w_ranks):
                lo, hi = _shard_range(n_rows, r, w_ranks)
                crc = zlib.crc32(np.ascontiguousarray(arr[lo:hi]).tobytes())
                want = manifest["crcs"][str(r)].get(name)
                if want is not None and crc != want:
                    raise IOError(
                        f"crc mismatch for {name} shard {r}: corrupt "
                        f"checkpoint {ckpt_path}")
        else:
            crc = zlib.crc32(arr.tobytes())
            want = manifest["crcs"]["0"].get(name)
            if want is not None and crc != want:
                raise IOError(f"crc mismatch for {name}")


def restore_sharded(tree_shapes, ckpt_path: str, rank: int = 0,
                    nranks: int = 1, verify: bool = True):
    """Read every array named by ``tree_shapes`` (a tree whose leaves have
    a ``shape``: arrays, tensors, meta tensors).  Elastic: any ``nranks``
    reads a checkpoint of any writer count, since offsets are global.
    Returns (tree, manifest)."""
    mfh = shardio.shard_open(manifest_path(ckpt_path), 0)
    msize = posix.stat(manifest_path(ckpt_path))
    manifest = json.loads(shardio.shard_read_at(mfh, msize, 0))
    shardio.shard_close(mfh)
    by_name = {e["name"]: e for e in manifest["arrays"]}

    fh = shardio.shard_open(os.path.join(ckpt_path, "arrays.bin"), 0)
    names, arrays = [], []
    for name, sds in reference_leaves(tree_shapes):
        e = by_name[name]
        shape, want = tuple(e["shape"]), tuple(sds.shape)
        if want != shape:
            raise ValueError(f"{name}: checkpoint shape {shape} != {want}")
        raw = shardio.shard_read_at(fh, e["nbytes"], e["offset"])
        arr = np.frombuffer(raw, dtype=np.uint8).copy()
        dtype = np.uint16 if e["dtype"] == "bfloat16" else np.dtype(
            e["dtype"])
        arrays.append(arr.view(dtype).reshape(shape))
        names.append(name)
    shardio.shard_close(fh)

    if verify:
        _verify(names, arrays, manifest, ckpt_path)
    leaves = {}
    for name, arr in zip(names, arrays):
        if by_name[name]["dtype"] == "bfloat16":
            arr = torch.from_numpy(arr).view(torch.bfloat16)
        leaves[name] = arr
    return _rebuild(tree_shapes, leaves), manifest


def latest_step(ckpt_dir: str) -> Optional[int]:
    """Largest committed step (ignores .tmp debris from crashes)."""
    if not os.path.isdir(ckpt_dir):
        return None
    steps = _committed_steps(ckpt_dir)
    return steps[-1] if steps else None


class CheckpointEngine:
    """Keep-k, optionally-async checkpoint manager for the train loop."""

    def __init__(self, ckpt_dir: str, keep: int = 2, rank: int = 0,
                 nranks: int = 1, comm: Optional[Comm] = None,
                 async_save: bool = False):
        self.dir = ckpt_dir
        self.keep = keep
        self.rank = rank
        self.nranks = nranks
        self.comm = comm or SoloComm()
        self.async_save = async_save
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        os.makedirs(ckpt_dir, exist_ok=True)

    def save(self, tree, step: int, meta: Optional[Dict] = None) -> None:
        """Snapshot ``tree`` to the host now, then write it (in a thread
        when ``async_save``)."""
        host_tree = tree_map(lambda x, _: _host_copy(x), tree)
        if self.async_save:
            self.wait()
            self._thread = threading.Thread(
                target=self._save_in_thread, args=(host_tree, step, meta),
                name=f"ckpt-async-{step}")
            self._thread.start()
        else:
            self._save_and_gc(host_tree, step, meta)

    def _save_in_thread(self, tree, step: int, meta) -> None:
        try:
            self._save_and_gc(tree, step, meta)
        except BaseException as e:  # noqa: BLE001 - re-raised by wait()
            self._error = e

    def _save_and_gc(self, tree, step: int, meta) -> None:
        save_sharded(tree, self.dir, step, self.rank, self.nranks,
                     self.comm, meta)
        if self.rank == 0:
            self._gc()

    def _gc(self) -> None:
        steps = _committed_steps(self.dir)
        for s in steps[: max(0, len(steps) - self.keep)]:
            d = os.path.join(self.dir, f"step_{s:08d}")
            for f in ("arrays.bin", "manifest.json"):
                p = os.path.join(d, f)
                if os.path.exists(p):
                    posix.unlink(p)
            posix.rmdir(d)

    def wait(self) -> None:
        """Join the async save, if one runs; raise what it raised."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def restore_latest(self, tree_shapes):
        """(tree, manifest) of the newest valid checkpoint, or None.
        Falls back to older checkpoints if the newest fails crc."""
        self.wait()
        step = latest_step(self.dir)
        while step is not None:
            path = os.path.join(self.dir, f"step_{step:08d}")
            try:
                return restore_sharded(tree_shapes, path, self.rank,
                                       self.nranks)
            except Exception:  # noqa: BLE001 - any unreadable checkpoint
                prev = [s for s in _committed_steps(self.dir) if s < step]
                step = prev[-1] if prev else None
        return None
