"""Signature-keyed closure cache with LRU eviction and hit/miss counters.

The pooled executor builds one encode closure per ``ExecutionSchedule``
signature, and the compiler memoizes schedules by structure. PyTorch runs
eagerly, so nothing is compiled: a miss means host work (scheduling, closure
building) for a signature not seen before. Because pool sizes are bucketed to
powers of two and batches are canonicalized, the signature set is small and
stable — after warmup every lookup should hit, and the serving engine reports
the misses as ``retraces``.

LRU eviction bounds host memory when a long-running job sees an unbounded
stream of signatures: evicting an entry is always safe — the next encounter
of that signature just rebuilds it.
"""
from __future__ import annotations

import collections
import threading
from typing import Any, Dict, Hashable, Optional

from repro_torch.obs.registry import get_registry


class CompileCache:
    """An LRU mapping ``signature -> schedule or encode closure`` with
    counters.

    Thread-safe: the serving batcher thread touches the caches while the
    main thread reads stats.

    Counters are registry metrics (``cache_hits{cache=<name>}`` etc.); they
    stay int-comparable attributes so both the call sites and a process-wide
    snapshot see the same numbers.
    """

    def __init__(self, capacity: int = 128, name: str = "compile"):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.capacity = capacity
        self.name = name
        self._metrics = get_registry().group("cache", cache=name)
        self.hits = self._metrics.counter("hits")
        self.misses = self._metrics.counter("misses")
        self.evictions = self._metrics.counter("evictions")
        self.size_gauge = self._metrics.gauge("size")
        self._d: "collections.OrderedDict[Hashable, Any]" = collections.OrderedDict()
        self._lock = threading.Lock()

    # ------------------------------------------------------------- mapping
    def get(self, key: Hashable) -> Optional[Any]:
        with self._lock:
            if key in self._d:
                self._d.move_to_end(key)
                self.hits += 1
                return self._d[key]
            self.misses += 1
            return None

    def put(self, key: Hashable, value: Any) -> Any:
        with self._lock:
            self._d[key] = value
            self._d.move_to_end(key)
            while len(self._d) > self.capacity:
                self._d.popitem(last=False)
                self.evictions += 1
            self.size_gauge.set(len(self._d))
        return value

    def __len__(self) -> int:
        return len(self._d)

    def __contains__(self, key: Hashable) -> bool:
        return key in self._d  # no counter bump: membership probe, not lookup

    # ------------------------------------------------------------- metrics
    @property
    def hit_rate(self) -> float:
        n = int(self.hits) + int(self.misses)
        return int(self.hits) / n if n else 0.0

    def stats(self) -> Dict[str, float]:
        return {
            "name": self.name,
            "size": len(self._d),
            "capacity": self.capacity,
            "hits": int(self.hits),
            "misses": int(self.misses),
            "evictions": int(self.evictions),
            "hit_rate": self.hit_rate,
        }

    def reset_counters(self) -> None:
        """Zero the counters (not the contents) — e.g. after benchmark warmup
        so steady-state hit rate is measured over the timed phase only."""
        with self._lock:
            self._metrics.reset()
            self.size_gauge.set(len(self._d))

    def clear(self) -> None:
        with self._lock:
            self._d.clear()
            self.size_gauge.set(0)
