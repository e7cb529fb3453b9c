"""Streaming JSONL export; the part of `repro.obs.sink` the campaign
supervisor's event stream needs.

`JsonlSink` is an append-only, size-rotated JSONL writer (thread-safe):
when the active file would exceed ``max_bytes`` it rotates ``path ->
path.1 -> ... -> path.{max_files-1}`` (oldest deleted), so a long
campaign holds at most ``max_bytes * max_files`` on disk. `read_jsonl`
parses one file back. ``EventLog(sink=...)`` (`repro_torch.obs.events`)
streams every appended event through the same writer.

Stdlib + numpy only. The HTTP push sink, the metrics sampler and the
decision consumer come with ROADMAP Queue 1 item 8.
"""
from __future__ import annotations

import json
import threading
from pathlib import Path
from typing import Any, List, Sequence

import numpy as np


class JsonlSink:
    """Append-only JSONL writer with size rotation.

    ``write(obj)`` serializes one row; when the active file would grow
    past ``max_bytes`` it is rotated first (``path.1`` newest rotated,
    higher suffixes older, beyond ``max_files`` deleted). ``written`` /
    ``rotations`` count activity; all methods are thread-safe.
    """

    def __init__(self, path, max_bytes: int = 32 << 20,
                 max_files: int = 4):
        if max_bytes < 1 or max_files < 1:
            raise ValueError("max_bytes and max_files must be >= 1")
        self.path = Path(path)
        self.max_bytes = int(max_bytes)
        self.max_files = int(max_files)
        self.written = 0
        self.rotations = 0
        self._lock = threading.Lock()
        self.path.parent.mkdir(parents=True, exist_ok=True)
        self._fh = open(self.path, "a", encoding="utf-8")
        self._size = self.path.stat().st_size

    def _rotate_locked(self) -> None:
        self._fh.close()
        oldest = self.path.with_name(
            f"{self.path.name}.{self.max_files - 1}")
        if oldest.exists():
            oldest.unlink()
        for i in range(self.max_files - 2, 0, -1):
            src = self.path.with_name(f"{self.path.name}.{i}")
            if src.exists():
                src.rename(self.path.with_name(f"{self.path.name}.{i + 1}"))
        if self.max_files > 1:
            self.path.rename(self.path.with_name(f"{self.path.name}.1"))
        else:
            self.path.unlink()
        self._fh = open(self.path, "a", encoding="utf-8")
        self._size = 0
        self.rotations += 1

    def write(self, obj: Any) -> None:
        line = json.dumps(obj, separators=(",", ":"),
                          default=_jsonable) + "\n"
        with self._lock:
            if self._size and self._size + len(line) > self.max_bytes:
                self._rotate_locked()
            self._fh.write(line)
            self._size += len(line)
            self.written += 1

    def write_many(self, objs: Sequence[Any]) -> None:
        for o in objs:
            self.write(o)

    def flush(self) -> None:
        with self._lock:
            self._fh.flush()

    def close(self) -> None:
        with self._lock:
            self._fh.close()

    def files(self) -> List[Path]:
        """Active file + rotated generations, newest first."""
        out = [self.path]
        for i in range(1, self.max_files):
            p = self.path.with_name(f"{self.path.name}.{i}")
            if p.exists():
                out.append(p)
        return out

    def __enter__(self) -> "JsonlSink":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def _jsonable(v):
    if isinstance(v, (np.floating, np.integer)):
        return v.item()
    if isinstance(v, np.ndarray):
        return v.tolist()
    return str(v)


def read_jsonl(path) -> List[dict]:
    """Parse one JSONL file (tests / analysis helper)."""
    with open(path) as fh:
        return [json.loads(ln) for ln in fh if ln.strip()]
