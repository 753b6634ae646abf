"""Continuous-batching serving engine.

Requests arrive one at a time with arbitrary patterns, and the engine's job
is to coalesce them into the same pooled micro-batches the executor runs:

* **Bounded admission queue** — ``submit`` enqueues a request and returns a
  ``concurrent.futures.Future``; a full queue blocks the caller (or raises
  ``queue.Full`` with a timeout), which is the backpressure contract: load
  beyond capacity queues at the CLIENT, not in unbounded engine memory.
* **Batcher thread** — drains the queue into operator-level micro-batches
  with a size/age flush policy: flush as soon as ``max_batch`` requests are
  pending, or when the oldest pending request has waited ``max_wait_ms``.
  One batcher thread by design: it owns every device launch, so the
  kernels run on its current CUDA stream in submission order.
* **Cross-request sharing** — exact-duplicate in-flight requests (same
  ``QueryInstance.key()``) coalesce onto ONE computed row before the batch
  is padded (``coalesced`` counter in ``stats()``), and the executor's plan
  compiler CSE-merges identical *subtrees* of the distinct queries that
  remain.
* **Signature-bucketed padding** — micro-batches pad to the next power-of-
  two size by repeating the last query (padded rows are computed and
  discarded). Bounding the batch-size set bounds the signature set: the
  scorer sees only pow2 ``B``s and the executor's per-signature encode
  closures stay hot, so a replayed workload runs at ZERO steady-state
  retraces.
* **All-entity scoring** — one per-model cached scorer (``scorer_for``),
  shared with the offline ``serve_batch``.
* **Out-of-core semantic serving** — with ``sem_cache``/``sem_rows_fn`` the
  batcher stages each micro-batch's anchors into the device hot set
  (``plan`` -> ``apply_to``) before encode, and scores all entities with
  ``score_all_chunked``, streaming H_sem from the store in chunks. One
  batcher thread means plan order is apply order.
* **Per-request latency accounting** — each future's result carries its
  end-to-end latency; ``stats()`` aggregates p50/p95/p99 over a bounded
  window of completed requests.

Offline/online parity: the engine and the one-shot ``launch/serve.py::
serve_batch`` baseline share the SAME executor closures, the SAME scorer and
the SAME ``topk_desc`` — so on identical micro-batch compositions their
per-request top-k is bit-identical.
"""
from __future__ import annotations

import dataclasses
import queue
import threading
import time
from collections import deque
from concurrent.futures import Future
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.executor import PooledExecutor
from repro_torch.core.patterns import QueryInstance
from repro_torch.device import resolve_device
from repro_torch.obs.registry import get_registry
from repro_torch.serving.loadgen import latency_summary


def topk_desc(scores: np.ndarray, k: int) -> np.ndarray:
    """Indices of the k largest entries per row, descending — argpartition
    (linear in E) followed by an O(k log k) sort of just the survivors."""
    k = min(k, scores.shape[1])
    part = np.argpartition(-scores, k - 1, axis=1)[:, :k]
    part_scores = np.take_along_axis(scores, part, axis=1)
    order = np.argsort(-part_scores, axis=1, kind="stable")
    return np.take_along_axis(part, order, axis=1)


# --------------------------------------------------------------------------
# Per-model scorer cache
# --------------------------------------------------------------------------

class CachedScorer:
    """``model.score_all`` under ``no_grad`` with a signature counter.

    ``traces`` counts the distinct (batch size, dtype) signatures the scorer
    has been called with — the eager counterpart of the reference's jit
    trace count, so a replayed pow2-bucketed workload keeps it flat."""

    def __init__(self, model):
        self._model = model
        self._seen = set()
        self._lock = threading.Lock()

    @torch.no_grad()
    def __call__(self, params, q):
        sig = (q.shape[0], q.dtype)
        with self._lock:
            self._seen.add(sig)
        return self._model.score_all(params, q)

    @property
    def traces(self) -> int:
        return len(self._seen)


_SCORER_LOCK = threading.Lock()


def scorer_for(model) -> CachedScorer:
    """The scorer cached on ``model``: the engine and ``serve_batch`` resolve
    the same object, so their scores come from one code path and share one
    signature count."""
    with _SCORER_LOCK:
        s = getattr(model, "_cached_scorer", None)
        if s is None:
            s = model._cached_scorer = CachedScorer(model)
    return s


def pad_to_bucket(queries: Sequence[QueryInstance]):
    """Pad a micro-batch to the next power-of-two length by repeating the
    last query. Real rows are untouched; the duplicate rows are scored and
    dropped. Returns ``(padded, n_real)``."""
    n = len(queries)
    if n == 0:
        return [], 0
    b = 1 << (n - 1).bit_length()
    return list(queries) + [queries[-1]] * (b - n), n


# --------------------------------------------------------------------------
# Engine
# --------------------------------------------------------------------------

@dataclasses.dataclass
class ServingConfig:
    max_batch: int = 16        # size-triggered flush threshold
    max_wait_ms: float = 5.0   # age-triggered flush: oldest pending request
    queue_depth: int = 256     # bounded admission queue (backpressure)
    top_k: int = 10
    record_batches: bool = False  # keep a log of (padded batch, results)
    latency_window: int = 8192    # completed-request latencies retained


@dataclasses.dataclass
class _Request:
    query: QueryInstance
    top_k: int
    future: Future
    t_submit: float


@dataclasses.dataclass
class BatchRecord:
    """One executed micro-batch, for offline-oracle replay: the exact padded
    composition the engine ran (duplicate in-flight requests coalesce to one
    computed row first, so ``queries`` holds UNIQUE real rows), plus one
    result per computed real row, in first-submission order. Each logged
    row records the selection at the engine's default ``top_k`` whenever any
    request for that row used it."""

    queries: List[QueryInstance]   # padded unique composition as executed
    n_real: int                    # unique real rows (pre-padding)
    flush: str                     # size | age | drain | retry
    results: List[Dict]            # one per real row


class ServingEngine:
    """Async continuous-batching NGDB query service on ``device`` (``cuda``
    unless given).

    ``submit`` is thread-safe and returns a future; a single batcher thread
    coalesces pending requests into pooled micro-batches and resolves the
    futures. ``sem_cache``/``sem_rows_fn`` switch on out-of-core serving:
    anchors stage into the hot set before encode, and all-entity scoring
    streams H_sem via ``sem_rows_fn`` (e.g. ``SemanticStore.read_rows``)."""

    def __init__(self, model, params, executor=None,
                 cfg: Optional[ServingConfig] = None, device=None,
                 sem_cache=None, sem_rows_fn=None, started: bool = True):
        self.model = model
        self.params = params
        self.cfg = cfg or ServingConfig()
        if self.cfg.max_batch < 1 or self.cfg.queue_depth < 1:
            raise ValueError("max_batch and queue_depth must be >= 1")
        if self.cfg.latency_window < 1:
            raise ValueError("latency_window must be >= 1")
        self.device = resolve_device(device)
        self.executor = executor or PooledExecutor(model, b_max=256,
                                                   device=self.device)
        if self.executor.device != self.device:
            raise ValueError(f"executor runs on {self.executor.device}, the "
                             f"engine on {self.device}")
        if sem_cache is not None and sem_rows_fn is None:
            raise ValueError(
                "out-of-core serving needs sem_rows_fn (e.g. store.read_rows)"
                " to stream H_sem for all-entity scoring")
        self.sem_cache = sem_cache
        self.sem_rows_fn = sem_rows_fn
        self._scorer = scorer_for(model)
        self._scorer_traces0 = self._scorer.traces
        self._sharing0 = dict(self.executor.sharing_stats())
        self._q: "queue.Queue" = queue.Queue(maxsize=self.cfg.queue_depth)
        # Unpack buffer for grouped admissions (``submit_many`` enqueues a
        # whole batch as ONE queue entry); owned by the batcher thread.
        self._pending: "deque[_Request]" = deque()
        self._stop = threading.Event()
        self._closed = False
        self._lock = threading.Lock()
        self._metrics = get_registry().group("serving")
        self._latency = self._metrics.histogram(
            "latency_ms", window=self.cfg.latency_window)
        self._submitted = self._metrics.counter("submitted")
        self._completed = self._metrics.counter("completed")
        self._batches = self._metrics.counter("batches")
        self._batch_rows = self._metrics.counter("batch_rows")
        self._padded_rows = self._metrics.counter("padded_rows")
        self._coalesced = self._metrics.counter("coalesced")
        self._failures = self._metrics.counter("failures")
        self._flushes = {k: self._metrics.counter("flushes", kind=k)
                         for k in ("size", "age", "drain", "retry")}
        self._queue_depth = self._metrics.gauge("queue_depth")
        self._occupancy = self._metrics.gauge("batch_occupancy")
        self.batch_log: List[BatchRecord] = []
        self._thread: Optional[threading.Thread] = None
        if started:
            self.start()

    # ------------------------------------------------------------ lifecycle
    def start(self) -> None:
        if self._thread is not None and self._thread.is_alive():
            return
        self._stop.clear()
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="serving-batcher")
        self._thread.start()

    def close(self, drain: bool = True, timeout: float = 60.0) -> None:
        """Stop accepting requests; by default serve everything already
        admitted (the batcher flushes the tail immediately once the queue
        is empty), then join the batcher thread."""
        with self._lock:
            self._closed = True
        if drain and self._thread is not None and self._thread.is_alive():
            deadline = time.monotonic() + timeout
            while time.monotonic() < deadline:
                with self._lock:
                    if self._completed >= self._submitted:
                        break
                time.sleep(0.005)
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
        # Anything still queued (drain=False or timeout) fails loudly rather
        # than leaving callers blocked on forever-pending futures.
        self._fail_queued()

    def _fail_queued(self) -> None:
        try:
            while True:
                entry = self._q.get_nowait()
                for r in (entry if type(entry) is list else (entry,)):
                    r.future.set_exception(RuntimeError("serving engine closed"))
                    with self._lock:
                        self._completed += 1
        except queue.Empty:
            pass

    def __enter__(self) -> "ServingEngine":
        self.start()
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # ------------------------------------------------------------ admission
    def submit(self, query: QueryInstance, top_k: Optional[int] = None,
               timeout: Optional[float] = None) -> Future:
        """Admit one request. Blocks when the admission queue is full
        (bounded-memory backpressure); with ``timeout`` raises ``queue.Full``
        instead. The returned future resolves to the same result dict
        ``serve_batch`` produces, plus ``latency_ms``/``batch_size``."""
        k = self.cfg.top_k if top_k is None else top_k
        if k < 1:
            raise ValueError(f"top_k must be >= 1, got {k}")
        with self._lock:
            if self._closed:
                raise RuntimeError("serving engine is closed")
            self._submitted += 1
        r = _Request(query, k, Future(), time.perf_counter())
        try:
            self._q.put(r, timeout=timeout)
        except queue.Full:
            with self._lock:
                self._submitted -= 1
            raise
        # close() may have stopped the batcher and drained the queue between
        # our _closed check and the put; a straggler landing in the
        # now-unwatched queue must fail, not strand its future forever.
        if self._stop.is_set():
            self._fail_queued()
        return r.future

    def submit_many(self, queries: Sequence[QueryInstance],
                    top_k: Optional[int] = None,
                    timeout: Optional[float] = None) -> List[Future]:
        """Admit a batch as ONE admission action: a single closed-check /
        counter update under the lock and a single queue entry for the whole
        group. The batcher unpacks the group in order, so batching behavior
        and results are identical to a ``submit`` loop. All requests in a
        group share one admission timestamp; the bounded queue counts a
        group as one entry."""
        if not queries:
            return []
        k = self.cfg.top_k if top_k is None else top_k
        if k < 1:
            raise ValueError(f"top_k must be >= 1, got {k}")
        with self._lock:
            if self._closed:
                raise RuntimeError("serving engine is closed")
            self._submitted += len(queries)
        t0 = time.perf_counter()
        group = [_Request(q, k, Future(), t0) for q in queries]
        try:
            self._q.put(group, timeout=timeout)
        except queue.Full:
            with self._lock:
                self._submitted -= len(group)
            raise
        if self._stop.is_set():
            self._fail_queued()
        return [r.future for r in group]

    # -------------------------------------------------------------- batcher
    def _next_request(self, timeout: Optional[float]) -> _Request:
        """Next single request for the batcher: drains the unpack buffer
        first, then the queue; a grouped entry refills the buffer.
        ``timeout=None`` means non-blocking. Raises ``queue.Empty`` exactly
        like ``Queue.get`` — and only when the buffer is empty."""
        if self._pending:
            return self._pending.popleft()
        entry = (self._q.get_nowait() if timeout is None
                 else self._q.get(timeout=timeout))
        if type(entry) is list:
            self._pending.extend(entry)
            return self._pending.popleft()
        return entry

    def _run(self) -> None:
        while True:
            try:
                first = self._next_request(0.05)
            except queue.Empty:
                if self._stop.is_set():
                    return
                continue
            batch = [first]
            # Age from SUBMIT time, not dequeue time: a request that sat in
            # the admission queue behind a long batch has already spent its
            # wait budget, so the latency bound covers queueing too.
            deadline = first.t_submit + self.cfg.max_wait_ms / 1e3
            flush = "size"
            while len(batch) < self.cfg.max_batch:
                try:
                    # Greedy first: coalesce everything ALREADY queued before
                    # consulting the age deadline.
                    batch.append(self._next_request(None))
                    continue
                except queue.Empty:
                    pass
                # Unlocked read: _closed only ever flips False -> True.
                if self._closed:
                    flush = "drain"  # tail: don't sit out the age window
                    break
                remaining = deadline - time.perf_counter()
                if remaining <= 0:
                    flush = "age"
                    break
                try:
                    batch.append(self._next_request(min(remaining, 0.05)))
                except queue.Empty:
                    continue
            self._queue_depth.set(self._q.qsize())
            self._execute(batch, flush)

    def _execute(self, batch: List[_Request], flush: str) -> None:
        # Exception, not BaseException: SystemExit/KeyboardInterrupt take
        # the batcher down rather than being swallowed into futures. Within
        # Exception, only recoverable per-request errors (e.g. malformed
        # pattern → KeyError) get poison isolation — MemoryError fails the
        # whole batch at once, never an N-fold solo-retry storm.
        try:
            results = self._serve(batch, flush)
        except Exception as e:
            if len(batch) > 1 and not isinstance(e, MemoryError):
                # Isolate the poison request: one malformed query must not
                # fail its co-batched neighbors.
                for r in batch:
                    self._execute([r], "retry")
                return
            for r in batch:
                r.future.set_exception(e)
            with self._lock:
                self._failures += len(batch)
                self._completed += len(batch)
            return
        t_done = time.perf_counter()
        n = len(batch)
        lats = []
        for r, res in zip(batch, results):
            lat_ms = (t_done - r.t_submit) * 1e3
            res["latency_ms"] = lat_ms
            res["batch_size"] = n
            lats.append(lat_ms)
        with self._lock:
            for lat_ms in lats:
                self._latency.observe(lat_ms)
            self._completed += n
        for r, res in zip(batch, results):
            r.future.set_result(res)

    def update_params(self, params) -> None:
        """Hot-swap the serving params. A batch that snapshotted the old
        params before the swap finishes on them; the next batch serves the
        new ones."""
        with self._lock:
            self.params = params

    def _serve(self, batch: List[_Request], flush: str) -> List[Dict]:
        # Exact-duplicate coalescing: in-flight requests whose query keys
        # match share ONE computed row; only the final selection differs.
        row_of: List[int] = []
        uniq: List[QueryInstance] = []
        index: Dict[Tuple, int] = {}
        for r in batch:
            key = r.query.key()
            j = index.get(key)
            if j is None:
                j = index[key] = len(uniq)
                uniq.append(r.query)
            row_of.append(j)
        padded, n_real = pad_to_bucket(uniq)
        with self._lock:
            params = self.params
        if self.sem_cache is not None:
            # Staging runs here, on the batcher thread, once per micro-batch:
            # the plan's store read + device copy, then the in-place apply,
            # both before the encode that gathers the rows.
            stage = self.sem_cache.plan(np.concatenate([q.anchors for q in padded]))
            if stage is not None:
                self.sem_cache.apply_to(params, stage)
        states = self.executor.encode(params, padded)
        if self.sem_cache is not None:
            scores = self.model.score_all_chunked(params, states, self.sem_rows_fn)
        else:
            scores = self._scorer(params, states).cpu().numpy()
        # Select per DISTINCT (row, k) group, not one k_max selection sliced
        # per request: argpartition at k_max can arrange boundary-tied ids
        # differently than argpartition at k, and the contract is exact
        # per-request equality with serve_batch(top_k=k).
        ks = scores.shape[1]
        sel_of: Dict[Tuple[int, int], np.ndarray] = {}
        for i, r in enumerate(batch):
            sel_of.setdefault((row_of[i], min(r.top_k, ks)), None)
        by_k: Dict[int, List[int]] = {}   # k -> unique computed rows
        for row, k in sel_of:
            by_k.setdefault(k, []).append(row)
        for k, rows in by_k.items():
            # Unique rows appear in ascending order, so the common single-k
            # group covers the contiguous prefix.
            sub = (scores[:len(rows)] if len(rows) == len(uniq)
                   else scores[rows])
            idx = topk_desc(sub, k)
            for j, row in enumerate(rows):
                sel_of[(row, k)] = idx[j]
        results: List[Optional[Dict]] = [None] * len(batch)
        log_rows: List[Optional[Dict]] = [None] * n_real
        default_k = min(self.cfg.top_k, ks)
        rounded = scores.round(3)
        for i, r in enumerate(batch):
            row = row_of[i]
            k = min(r.top_k, ks)
            sel = sel_of[(row, k)]
            results[i] = {
                "pattern": r.query.pattern,
                "anchors": r.query.anchors.tolist(),
                "relations": r.query.relations.tolist(),
                "top_entities": sel.tolist(),
                "scores": rounded[row, sel].tolist(),
            }
            # Log rows prefer the engine's default k: offline-oracle replay
            # serves rec.queries at ONE fixed k.
            if log_rows[row] is None or (
                    k == default_k
                    and len(log_rows[row]["top_entities"]) != default_k):
                log_rows[row] = results[i]
        with self._lock:
            self._batches += 1
            self._batch_rows += len(padded)
            self._padded_rows += len(padded) - n_real
            self._coalesced += len(batch) - len(uniq)
            self._occupancy.set(n_real / len(padded))
            self._flushes[flush].inc()
            if self.cfg.record_batches:
                self.batch_log.append(BatchRecord(
                    queries=padded, n_real=n_real, flush=flush,
                    results=log_rows))
        return results

    # -------------------------------------------------------------- metrics
    def retraces(self) -> int:
        """Cold signature work since the last ``reset_counters``: executor
        cache misses (schedule/encode) + new scorer signatures. A replayed
        workload keeps this at ZERO."""
        cs = self.executor.cache_stats()
        return (sum(int(v["misses"]) for v in cs.values())
                + self._scorer.traces - self._scorer_traces0)

    def reset_counters(self, clear_log: bool = True) -> None:
        """Zero retrace/latency/flush counters (after warmup) — closures and
        cache contents are kept. submitted/completed survive so ``close``'s
        drain accounting stays truthful."""
        self.executor.reset_cache_counters()
        if self.sem_cache is not None:
            self.sem_cache.reset_counters()
        self._scorer_traces0 = self._scorer.traces
        self._sharing0 = dict(self.executor.sharing_stats())
        with self._lock:
            self._latency.reset()
            self._metrics.reset(only=[
                self._batches, self._batch_rows, self._padded_rows,
                self._coalesced, self._failures, *self._flushes.values()])
            if clear_log:
                self.batch_log = []

    def stats(self) -> Dict:
        with self._lock:
            lat = np.asarray(self._latency.window_values(), dtype=np.float64)
            out = {
                "submitted": int(self._submitted),
                "completed": int(self._completed),
                "failures": int(self._failures),
                "batches": int(self._batches),
                "flushes": {k: int(c) for k, c in self._flushes.items()},
                "mean_batch_size": (int(self._batch_rows) / int(self._batches)
                                    if self._batches else 0.0),
                "padded_row_frac": (
                    int(self._padded_rows) / int(self._batch_rows)
                    if self._batch_rows else 0.0),
                # duplicate in-flight requests served off a co-batched twin's
                # computation (same QueryInstance.key())
                "coalesced": int(self._coalesced),
            }
        if len(lat):
            out["latency_ms"] = {**latency_summary(lat),
                                 "max": float(lat.max()),
                                 "window_n": int(len(lat)),
                                 "window": int(self._latency.window)}
        out["retraces"] = self.retraces()
        out["caches"] = self.executor.cache_stats()
        # Same window as the engine's own counters: delta since the last
        # reset_counters(), not the executor's lifetime totals.
        sh = self.executor.sharing_stats()
        before = sh["nodes_before"] - self._sharing0["nodes_before"]
        after = sh["nodes_after"] - self._sharing0["nodes_after"]
        out["sharing"] = {
            "nodes_before": before,
            "nodes_after": after,
            "pooled_rows_saved": before - after,
            "saved_frac": (before - after) / max(before, 1),
        }
        out["scorer_traces"] = self._scorer.traces - self._scorer_traces0
        out["plan_cache"] = sh["plan_cache"]
        if self.sem_cache is not None:
            out["sem_cache"] = self.sem_cache.stats()
        return out
