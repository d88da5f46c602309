"""Shard-I/O layer (the framework's MPI-IO analogue) -- paper Fig 1 middle.

Collective shard read/write used by the checkpoint engine: every host writes
its shard of each global array into a shared file at
``offset = rank * shard_bytes`` -- exactly the strided pattern of paper
Listing 3, which the compression pipeline recognizes across ranks.

Implementations call down through the traced POSIX facade, so traces show
the full call chain with increasing call depth (paper §2.2.1 "Call Depth").
"""

from __future__ import annotations

import os as _os

from ..specs import REGISTRY, Arg, FnSpec, Role
from ..wrappers import generate_wrappers
from . import posix

_L = "shardio"


def _shard_open_impl(path, mode):
    flags = _os.O_RDWR | _os.O_CREAT if mode == 1 else _os.O_RDONLY
    return posix.open(path, flags, 0o644)


def _shard_write_at_impl(fh, buf, offset):
    return posix.pwrite(fh, buf, offset)


def _shard_read_at_impl(fh, count, offset):
    return posix.pread(fh, count, offset)


def _shard_sync_impl(fh):
    return posix.fsync(fh)


def _shard_close_impl(fh):
    return posix.close(fh)


def _shard_commit_impl(tmp_path, final_path):
    return posix.rename(tmp_path, final_path)


SPECS = [
    FnSpec("shard_open", _L, [Arg("path", Role.PATH), Arg("mode", Role.VAL)],
           impl=_shard_open_impl, ret_role=Role.HANDLE, collective=True),
    FnSpec("shard_write_at", _L, [Arg("fh", Role.HANDLE), Arg("buf", Role.BUF),
                                  Arg("offset", Role.OFFSET)],
           impl=_shard_write_at_impl, ret_role=Role.SIZE),
    FnSpec("shard_read_at", _L, [Arg("fh", Role.HANDLE), Arg("count", Role.SIZE),
                                 Arg("offset", Role.OFFSET)],
           impl=_shard_read_at_impl, ret_role=Role.BUF),
    FnSpec("shard_sync", _L, [Arg("fh", Role.HANDLE)], impl=_shard_sync_impl),
    FnSpec("shard_close", _L, [Arg("fh", Role.HANDLE)], impl=_shard_close_impl),
    FnSpec("shard_commit", _L, [Arg("tmp_path", Role.PATH),
                                Arg("final_path", Role.PATH)],
           impl=_shard_commit_impl),
]

_api = generate_wrappers(SPECS, REGISTRY)

shard_open = _api.shard_open
shard_write_at = _api.shard_write_at
shard_read_at = _api.shard_read_at
shard_sync = _api.shard_sync
shard_close = _api.shard_close
shard_commit = _api.shard_commit
