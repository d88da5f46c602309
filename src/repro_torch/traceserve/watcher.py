"""Job discovery: manifest scans over a root of trace directories.

A *job* is any direct subdirectory of the watched root that is a trace:
either a streaming directory (top-level ``manifest.json``, the layout
``Recorder.flush`` commits epoch segments into) or a plain single-segment
trace (``metadata.json``).  Scanning is metadata-only -- the manifest and,
when validation is on, each segment's files are checked against their
recorded sizes/CRC32s, but no CST/CFG blob is ever decoded here.

Committed segments are immutable (atomic rename + manifest append), so
validation results are cached per ``(job, segment)``: a scan of a root
with hundreds of jobs re-reads only each job's manifest, not the payload
of every epoch ever committed.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from ..core import trace_format


@dataclass
class JobInfo:
    """One watched trace directory, as discovered by a manifest scan."""

    name: str
    path: str
    is_stream: bool
    n_segments: int = 0
    newest_epoch: int = -1
    n_records: int = 0                 # summed from manifest entries
    has_merged: bool = False           # cleanly finalized
    degraded: List[str] = field(default_factory=list)
    quarantined: List[Dict[str, str]] = field(default_factory=list)
    error: Optional[str] = None        # unreadable manifest etc.

    @property
    def complete(self) -> bool:
        return not (self.degraded or self.quarantined or self.error)


class JobWatcher:
    """Discover jobs under ``root`` and classify their segments.

    ``validate=True`` (default) runs :func:`trace_format.validate_segment`
    on every newly seen segment -- size and CRC32 checks -- and reports
    failures as ``quarantined`` (the reader-side stitch will skip exactly
    these).  Because committed segments never change, each is validated
    once per watcher lifetime.
    """

    def __init__(self, root: str, validate: bool = True) -> None:
        self.root = root
        self.validate = validate
        self._val_cache: Dict[tuple, Optional[str]] = {}

    def scan(self) -> Dict[str, JobInfo]:
        """All jobs under the root, keyed by directory name.  Directories
        that are not traces (no manifest, no metadata) are ignored; a job
        whose manifest is unreadable is reported with ``error`` set."""
        jobs: Dict[str, JobInfo] = {}
        try:
            names = sorted(os.listdir(self.root))
        except OSError:
            return jobs
        for name in names:
            path = os.path.join(self.root, name)
            if not os.path.isdir(path):
                continue
            info = self.probe(name, path)
            if info is not None:
                jobs[name] = info
        return jobs

    def probe(self, name: str, path: str) -> Optional[JobInfo]:
        """Classify one directory; None when it is not a trace at all."""
        if trace_format.is_stream_dir(path):
            info = JobInfo(name=name, path=path, is_stream=True)
            try:
                manifest = trace_format.read_manifest(path)
            except trace_format.TraceFormatError as e:
                info.error = str(e)
                return info
            entries = manifest.get("segments", [])
            info.n_segments = len(entries)
            info.has_merged = manifest.get("merged") is not None
            for entry in entries:
                info.newest_epoch = max(info.newest_epoch,
                                        int(entry.get("epoch", -1)))
                info.n_records += int(entry.get("n_records", 0))
                if "ranks_present" in entry:
                    info.degraded.append(entry["name"])
                if self.validate:
                    reason = self._validate(path, entry)
                    if reason is not None:
                        info.quarantined.append(
                            {"segment": entry["name"], "reason": reason})
            return info
        if os.path.exists(os.path.join(path, "metadata.json")):
            return JobInfo(name=name, path=path, is_stream=False,
                           n_segments=1)
        return None

    def _validate(self, path: str, entry: Dict) -> Optional[str]:
        key = (path, entry["name"])
        if key not in self._val_cache:
            self._val_cache[key] = trace_format.validate_segment(path, entry)
        return self._val_cache[key]
