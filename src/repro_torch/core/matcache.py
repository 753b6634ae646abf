"""Materialized-subquery cache: encoded pooled rows persisted across batches.

The plan cache (``core/compiler.py::PlanCache``) removes the host-side
compile cost of a repeated subquery; this module removes the DEVICE cost.
A ``MaterializedSubqueryCache`` holds the encoded answer rows of hot queries
keyed by ``QueryInstance.key()`` in a bounded row buffer with CLOCK
(second-chance) eviction — the slot/owner/ref discipline of
``semantic/store.py::SemanticCache`` — so a duplicate query arriving in a
LATER batch is served off its cached row instead of re-encoded.

Layout: the bookkeeping (key -> slot map, slot owners, version stamps,
reference bits, the clock hand) lives on the host; the ``[budget, dim]`` row
buffer lives on the device of the rows inserted into it (the executor's
device), allocated at the first insert. ``lookup`` gathers the hit rows with
one ``index_select`` into a new tensor, and ``insert`` scatters with one
``index_copy_``; both are launched on the caller's current stream, so an
insert issued after a lookup is stream-ordered after the gather and cannot
tear a row the caller holds. No row is copied to the host, and on CUDA the
slot indices reach the device through pinned memory without a host sync.

Correctness is entirely an invalidation story, and the invalidation is a
single version stamp:

* every row is stamped with the cache ``version`` it was computed under;
* ``bump_version`` is O(1) — it increments the version, so every resident
  row becomes unservable at once (stale slots are reclaimed first by the
  CLOCK sweep, never returned by ``lookup``);
* the stamp bumps on every **param update** (the trainer after each Adam
  step, the serving engine on ``update_params``) and on every **KG write**
  (``KnowledgeGraph.add_triples`` notifies listeners registered via
  ``watch_kg``);
* consumers may PIN the version they paired with a params snapshot
  (``version=`` on ``lookup``/``insert``): a lookup serves only rows
  stamped exactly that version, and an insert of rows computed under a
  pinned version is DROPPED when the cache has moved on (``stale_drops``);
* graph-version-pinned queries additionally fold the pinned
  ``graph_version`` into the row key itself
  (``PooledExecutor.encode(graph_version=...)``).

Materialized rows are consumed on inference paths only
(``PooledExecutor.encode``, the serving batcher) — never inside a training
step, where a constant row would detach the gradient of its subtree. Within
one params version the pooled operators are row-wise and composition-
independent, so a cached row is bitwise the row a fresh no-cache encode
would produce.
"""
from __future__ import annotations

import threading
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.obs.registry import get_registry


def index_tensor(idx: Sequence[int], device) -> torch.Tensor:
    """Host indices as an int64 tensor on ``device``. On CUDA the copy goes
    from pinned memory without blocking the host; the caching host allocator
    keeps the pinned block until the copy has run."""
    host = torch.as_tensor(np.asarray(idx, dtype=np.int64))
    if torch.device(device).type != "cuda":
        return host.to(device)
    return host.pin_memory().to(device, non_blocking=True)


class MaterializedSubqueryCache:
    """Bounded, version-stamped cache of encoded query rows.

    Thread-safe: the serving batcher, the pipeline scheduler thread and
    trainer/eval callers share one instance. Bookkeeping and the launches
    on the buffer happen under the lock."""

    def __init__(self, budget_rows: int, name: str = "materialized"):
        if budget_rows < 1:
            raise ValueError(f"budget_rows must be >= 1, got {budget_rows}")
        self.budget_rows = budget_rows
        self.name = name
        self._lock = threading.Lock()
        self._version = 0
        self._buf: Optional[torch.Tensor] = None   # [budget, dim], lazy
        self._slot_of: Dict[Tuple, int] = {}       # key -> slot
        self._owner: List[Optional[Tuple]] = [None] * budget_rows
        self._stamp = np.full(budget_rows, -1, dtype=np.int64)
        self._ref = np.zeros(budget_rows, dtype=bool)
        self._hand = 0
        self._metrics = get_registry().group("mat_cache", cache=name)
        self.hits = self._metrics.counter("hits")
        self.misses = self._metrics.counter("misses")
        self.probe_hits = self._metrics.counter("probe_hits")
        self.probe_misses = self._metrics.counter("probe_misses")
        self.inserts = self._metrics.counter("inserts")
        self.evictions = self._metrics.counter("evictions")
        self.invalidations = self._metrics.counter("invalidations")
        self.stale_drops = self._metrics.counter("stale_drops")
        self._inval_reasons: Dict[str, int] = {}

    # -------------------------------------------------------------- version
    @property
    def version(self) -> int:
        return self._version

    def bump_version(self, reason: str = "param_update") -> int:
        """O(1) whole-cache invalidation: every resident row's stamp no
        longer matches, so nothing encoded before this call can be served
        at the new version."""
        with self._lock:
            self._version += 1
            self.invalidations += 1
            self._inval_reasons[reason] = self._inval_reasons.get(reason, 0) + 1
            return self._version

    def watch_kg(self, kg) -> None:
        """Subscribe to KG writes: a committed write calls the listener
        (reason ``"kg_write"`` / ``"entity_add"``), bumping the version. A
        no-op write never fires, so warm rows survive it. The graph holds
        the listener weakly, so dropping the cache lets it be collected."""
        kg.add_invalidation_listener(self.bump_version)

    # --------------------------------------------------------------- access
    def lookup_rows(self, keys: Sequence[Tuple], version: Optional[int] = None
                    ) -> Tuple[List[int], Optional[torch.Tensor]]:
        """``(hit indices into keys, their rows)``: the rows valid at
        ``version`` (default: current) as one gathered copy
        ``[len(hits), dim]``, or ``None`` when nothing hit. A key whose slot
        carries any other stamp is a miss — stale rows are never returned."""
        hit, slots = [], []
        with self._lock:
            v = self._version if version is None else version
            for i, k in enumerate(keys):
                s = self._slot_of.get(k)
                if s is not None and self._stamp[s] == v:
                    self._ref[s] = True
                    hit.append(i)
                    slots.append(s)
            self.hits += len(hit)
            self.misses += len(keys) - len(hit)
            if not hit:
                return hit, None
            rows = self._buf.index_select(0, index_tensor(slots, self._buf.device))
        return hit, rows

    def lookup(self, keys: Sequence[Tuple], version: Optional[int] = None
               ) -> Dict[int, torch.Tensor]:
        """``lookup_rows`` as ``{index into keys -> row}``; the rows are
        views of one gathered copy."""
        hit, rows = self.lookup_rows(keys, version)
        return {i: rows[j] for j, i in enumerate(hit)}

    def probe(self, keys: Sequence[Tuple], version: Optional[int] = None
              ) -> int:
        """Count how many of ``keys`` are resident at ``version`` WITHOUT
        gathering rows or touching the hit/miss counters — the pipeline
        scheduler thread's staging probe (training never consumes
        materialized rows, so it only observes)."""
        n = 0
        with self._lock:
            v = self._version if version is None else version
            for k in keys:
                s = self._slot_of.get(k)
                if s is not None and self._stamp[s] == v:
                    n += 1
            self.probe_hits += n
            self.probe_misses += len(keys) - n
        return n

    def insert(self, keys: Sequence[Tuple], rows,
               version: Optional[int] = None) -> int:
        """Store ``rows[i]`` under ``keys[i]``, stamped ``version`` (default:
        current). If the caller pinned a version and the cache has since been
        bumped, the whole insert is dropped (``stale_drops``). ``rows`` is a
        tensor (or array) ``[len(keys), dim]``; the buffer is allocated on
        its device at the first insert. Returns the number of rows stored."""
        rows = torch.as_tensor(rows)
        if len(keys) != rows.shape[0]:
            raise ValueError(f"{len(keys)} keys for {rows.shape[0]} rows")
        with self._lock:
            v = self._version if version is None else version
            if v != self._version:
                self.stale_drops += len(keys)
                return 0
            if self._buf is None:
                self._buf = torch.empty((self.budget_rows, rows.shape[1]),
                                        dtype=rows.dtype, device=rows.device)
            elif rows.shape[1] != self._buf.shape[1]:
                raise ValueError(
                    f"row dim {rows.shape[1]} != cache dim {self._buf.shape[1]}"
                    " — one cache serves one model")
            # Slot of each key in insertion order; a slot taken twice in one
            # insert keeps its last row, as sequential writes would.
            src_of: Dict[int, int] = {}
            for i, k in enumerate(keys):
                s = self._slot_of.get(k)
                if s is None:
                    s = self._take_slot()
                    old = self._owner[s]
                    if old is not None:
                        del self._slot_of[old]
                        self.evictions += 1
                    self._owner[s] = k
                    self._slot_of[k] = s
                src_of[s] = i
                self._stamp[s] = v
                self._ref[s] = True
                self.inserts += 1
            if src_of:
                dev = self._buf.device
                slots = list(src_of)
                src = rows.to(dev, self._buf.dtype)
                if len(src_of) != len(keys):
                    src = src.index_select(0, index_tensor(list(src_of.values()), dev))
                self._buf.index_copy_(0, index_tensor(slots, dev), src)
            return len(keys)

    def _take_slot(self) -> int:
        """CLOCK sweep (lock held): free and STALE slots are reclaimed
        immediately; live rows get one second chance."""
        for _ in range(2 * self.budget_rows):
            s = self._hand
            self._hand = (self._hand + 1) % self.budget_rows
            if self._owner[s] is None or self._stamp[s] != self._version:
                return s
            if self._ref[s]:
                self._ref[s] = False
                continue
            return s
        return self._hand  # unreachable: a full sweep clears every ref bit

    # -------------------------------------------------------------- metrics
    @property
    def hit_rate(self) -> float:
        n = int(self.hits) + int(self.misses)
        return int(self.hits) / n if n else 0.0

    def stats(self) -> Dict:
        with self._lock:
            live = int(np.count_nonzero(
                (self._stamp == self._version)
                & np.asarray([o is not None for o in self._owner])))
            return {
                "name": self.name,
                "capacity": self.budget_rows,
                "resident": len(self._slot_of),
                "live": live,                  # resident AND current-version
                "version": self._version,
                "hits": int(self.hits),
                "misses": int(self.misses),
                "hit_rate": self.hit_rate,
                "probe_hits": int(self.probe_hits),
                "probe_misses": int(self.probe_misses),
                "inserts": int(self.inserts),
                "evictions": int(self.evictions),
                "invalidations": int(self.invalidations),
                "stale_drops": int(self.stale_drops),
                "invalidation_reasons": dict(self._inval_reasons),
            }

    def reset_counters(self) -> None:
        """Zero the counters (contents, version and stamps kept) — e.g.
        after serving warmup so the steady-state hit rate is measured over
        the timed phase only."""
        with self._lock:
            self._metrics.reset()
            self._inval_reasons = {}

    def clear(self) -> None:
        with self._lock:
            self._slot_of.clear()
            self._owner = [None] * self.budget_rows
            self._stamp.fill(-1)
            self._ref.fill(False)
            self._hand = 0

    # ---------------------------------------------------------------- debug
    def check_consistent(self) -> None:
        """Invariant check for the concurrency tests: the key->slot map and
        the slot->owner array must be exact inverses, and every mapped slot
        must be in range."""
        with self._lock:
            for k, s in self._slot_of.items():
                assert 0 <= s < self.budget_rows, (k, s)
                assert self._owner[s] == k, (k, s, self._owner[s])
            owners = [o for o in self._owner if o is not None]
            assert len(owners) == len(self._slot_of)
            assert set(owners) == set(self._slot_of)
