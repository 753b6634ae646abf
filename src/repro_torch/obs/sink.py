"""JSONL metrics sink: one JSON object per line, thread-safe, append-order.

The trainer writes one record per retired step (phase durations, bubble
fraction, queue depths); launches write a final registry snapshot record.
Readers (``repro_torch.obs.report``, ``chip_smoke.py``) stream lines — no
trailing-comma / partial-file hazards on crash, by construction.
"""
from __future__ import annotations

import json
import threading
from typing import Any, Dict, List, Optional

__all__ = ["MetricsSink", "read_jsonl"]


class MetricsSink:
    """Thread-safe line-buffered JSONL writer. ``None`` path = disabled sink
    (every ``write`` is a cheap no-op), so call sites need no gating."""

    def __init__(self, path: Optional[str]):
        self.path = path
        self._lock = threading.Lock()
        self._f = open(path, "w") if path else None
        self.records = 0

    @property
    def enabled(self) -> bool:
        return self._f is not None

    def write(self, record: Dict[str, Any]) -> None:
        if self._f is None:
            return
        line = json.dumps(record)
        with self._lock:
            self._f.write(line + "\n")
            self._f.flush()
            self.records += 1

    def close(self) -> None:
        with self._lock:
            if self._f is not None:
                self._f.close()
                self._f = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False


def read_jsonl(path: str) -> List[Dict[str, Any]]:
    out = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line:
                out.append(json.loads(line))
    return out
