"""Function-signature specifications (the paper's Section 2.1 signature files).

The original Recorder auto-generates a C tracing wrapper per function from a
signature file.  Here the signature files are declarative ``FnSpec`` tables;
``wrappers.generate_wrappers`` turns each into a generated three-phase
wrapper (prologue / real call / epilogue).

Argument *roles* drive the pattern-recognition pipeline:

  PATH    file path (subject to runtime prefix filtering, Section 2.1.1)
  HANDLE  file handle (canonicalized to a group-unique id, Section 3.2.2)
  OFFSET  pattern-eligible integer (``i*a+b`` intra / ``rank*a+b`` inter)
  SIZE    byte count (stored verbatim; usually constant, dedupes in the CST)
  BUF     data buffer (length recorded, contents never stored)
  VAL     any other argument, stored verbatim
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple


class Role(enum.Enum):
    PATH = "path"
    HANDLE = "handle"
    OFFSET = "offset"
    SIZE = "size"
    BUF = "buf"
    VAL = "val"


#: the data-moving functions -- the calls whose BUF/SIZE argument (or int
#: return) counts as transferred bytes in bandwidth analyses.  One
#: definition site shared by the record path (per-timestamp-block byte
#: counters) and the read side (``traceview``): the two MUST agree or
#: windowed bandwidth stops being exact.
DATA_FUNCS = frozenset({"pwrite", "write", "pread", "read",
                        "shard_write_at", "shard_read_at"})


@dataclass
class Arg:
    name: str
    role: Role = Role.VAL


@dataclass
class FnSpec:
    name: str
    layer: str
    args: List[Arg]
    impl: Optional[Callable] = None   # the "real" function the wrapper calls
    ret_role: Role = Role.VAL         # HANDLE => register returned handle
    collective: bool = False          # opens that assign group-unique ids

    @property
    def offset_positions(self) -> Tuple[int, ...]:
        return tuple(i for i, a in enumerate(self.args) if a.role == Role.OFFSET)

    @property
    def handle_positions(self) -> Tuple[int, ...]:
        return tuple(i for i, a in enumerate(self.args) if a.role == Role.HANDLE)

    @property
    def path_positions(self) -> Tuple[int, ...]:
        return tuple(i for i, a in enumerate(self.args) if a.role == Role.PATH)


class FunctionRegistry:
    """Global id <-> spec mapping, identical on every rank (static code)."""

    def __init__(self) -> None:
        self._specs: List[FnSpec] = []
        self._by_name: Dict[str, int] = {}

    def register(self, spec: FnSpec) -> int:
        if spec.name in self._by_name:
            raise ValueError(f"duplicate function spec {spec.name!r}")
        fid = len(self._specs)
        self._specs.append(spec)
        self._by_name[spec.name] = fid
        return fid

    def register_all(self, specs: List[FnSpec]) -> List[int]:
        return [self.register(s) for s in specs]

    def spec(self, func_id: int) -> FnSpec:
        return self._specs[func_id]

    def id_of(self, name: str) -> int:
        return self._by_name[name]

    def __len__(self) -> int:
        return len(self._specs)

    def name_table(self) -> Dict[int, str]:
        return {i: s.name for i, s in enumerate(self._specs)}

    def layers(self) -> List[str]:
        return sorted({s.layer for s in self._specs})


# The process-wide registry.  API modules (core/apis/*.py) register into it at
# import time; ids are stable because import order is deterministic
# (apis/__init__ imports them in a fixed order).
REGISTRY = FunctionRegistry()
