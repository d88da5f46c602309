"""POSIX layer (traced facade over ``os``) -- paper Fig 1 bottom layer.

The framework's checkpoint/data subsystems perform all file I/O through this
module so every call is interceptable (the LD_PRELOAD analogue; see
DESIGN.md).  When no recorder is attached, each function is a direct
passthrough to ``os``.
"""

from __future__ import annotations

import os

from ..specs import REGISTRY, Arg, FnSpec, Role
from ..wrappers import generate_wrappers

_L = "posix"

SPECS = [
    FnSpec("open", _L, [Arg("path", Role.PATH), Arg("flags", Role.VAL),
                        Arg("mode", Role.VAL)],
           impl=os.open, ret_role=Role.HANDLE),
    FnSpec("close", _L, [Arg("fd", Role.HANDLE)], impl=os.close),
    FnSpec("pwrite", _L, [Arg("fd", Role.HANDLE), Arg("buf", Role.BUF),
                          Arg("offset", Role.OFFSET)],
           impl=os.pwrite, ret_role=Role.SIZE),
    FnSpec("pread", _L, [Arg("fd", Role.HANDLE), Arg("count", Role.SIZE),
                         Arg("offset", Role.OFFSET)],
           impl=os.pread, ret_role=Role.BUF),
    FnSpec("write", _L, [Arg("fd", Role.HANDLE), Arg("buf", Role.BUF)],
           impl=os.write, ret_role=Role.SIZE),
    FnSpec("read", _L, [Arg("fd", Role.HANDLE), Arg("count", Role.SIZE)],
           impl=os.read, ret_role=Role.BUF),
    FnSpec("lseek", _L, [Arg("fd", Role.HANDLE), Arg("offset", Role.OFFSET),
                         Arg("whence", Role.VAL)],
           impl=os.lseek, ret_role=Role.OFFSET),
    FnSpec("fsync", _L, [Arg("fd", Role.HANDLE)], impl=os.fsync),
    FnSpec("ftruncate", _L, [Arg("fd", Role.HANDLE), Arg("length", Role.SIZE)],
           impl=os.ftruncate),
    FnSpec("rename", _L, [Arg("src", Role.PATH), Arg("dst", Role.PATH)],
           impl=os.rename),
    FnSpec("unlink", _L, [Arg("path", Role.PATH)], impl=os.unlink),
    # real POSIX mkdir: creating an existing directory fails with EEXIST
    # (recorded as an err return); use makedirs for idempotent recursive
    # creation (the checkpoint engine's commit-dir preparation)
    FnSpec("mkdir", _L, [Arg("path", Role.PATH), Arg("mode", Role.VAL)],
           impl=os.mkdir),
    FnSpec("makedirs", _L, [Arg("path", Role.PATH), Arg("mode", Role.VAL)],
           impl=lambda path, mode=0o777: os.makedirs(path, mode, exist_ok=True)),
    FnSpec("rmdir", _L, [Arg("path", Role.PATH)], impl=os.rmdir),
    FnSpec("stat", _L, [Arg("path", Role.PATH)],
           impl=lambda path: os.stat(path).st_size),
    FnSpec("access", _L, [Arg("path", Role.PATH), Arg("mode", Role.VAL)],
           impl=os.access),
    FnSpec("chmod", _L, [Arg("path", Role.PATH), Arg("mode", Role.VAL)],
           impl=os.chmod),
    FnSpec("opendir", _L, [Arg("path", Role.PATH)],
           impl=lambda path: len(os.listdir(path))),
    FnSpec("readlink", _L, [Arg("path", Role.PATH)], impl=os.readlink),
    FnSpec("symlink", _L, [Arg("src", Role.PATH), Arg("dst", Role.PATH)],
           impl=os.symlink),
]

_api = generate_wrappers(SPECS, REGISTRY)

open = _api.open
close = _api.close
pwrite = _api.pwrite
pread = _api.pread
write = _api.write
read = _api.read
lseek = _api.lseek
fsync = _api.fsync
ftruncate = _api.ftruncate
rename = _api.rename
unlink = _api.unlink
mkdir = _api.mkdir
makedirs = _api.makedirs
rmdir = _api.rmdir
stat = _api.stat
access = _api.access
chmod = _api.chmod
opendir = _api.opendir
readlink = _api.readlink
symlink = _api.symlink
