"""Call Signature Table (paper Section 3.1).

The CST associates each unique call signature with a terminal symbol.  It is
a hash table keyed on the deterministic signature bytes; values are terminal
ids handed to the Sequitur grammar.
"""

from __future__ import annotations

from typing import Dict, List

from .encoding import read_uvarint, write_uvarint


class CST:
    def __init__(self) -> None:
        self._table: Dict[bytes, int] = {}
        self._entries: List[bytes] = []

    def intern(self, sig: bytes) -> int:
        """Return the terminal for ``sig``, creating a new entry if needed."""
        t = self._table.get(sig)
        if t is None:
            t = len(self._entries)
            self._table[sig] = t
            self._entries.append(sig)
        return t

    def __len__(self) -> int:
        return len(self._entries)

    @property
    def entries(self) -> List[bytes]:
        return self._entries

    def signature(self, terminal: int) -> bytes:
        return self._entries[terminal]

    # serialization ---------------------------------------------------------

    def serialize(self) -> bytes:
        out = bytearray()
        write_uvarint(out, len(self._entries))
        for e in self._entries:
            write_uvarint(out, len(e))
            out.extend(e)
        return bytes(out)

    @classmethod
    def deserialize(cls, buf: bytes) -> "CST":
        cst = cls()
        pos = 0
        n, pos = read_uvarint(buf, pos)
        for _ in range(n):
            ln, pos = read_uvarint(buf, pos)
            cst.intern(bytes(buf[pos : pos + ln]))
            pos += ln
        return cst
