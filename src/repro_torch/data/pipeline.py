"""Producer/consumer data pipeline (§4.3 "Heterogeneous Pipelining").

While the card executes the current pooled batch, host threads sample the
next queries, draw its negatives, compile its plan and copy its inputs to the
card. This is the GPU counterpart of the paper's CPU↔GPU pipeline and of the
JAX package's ``data/pipeline.py``:

* ``BatchPrefetcher`` — sampling workers producing raw query batches.
* ``PreparedBatchPrefetcher`` — one background *scheduler thread* that
  consumes raw batches and runs everything that would sit on the training
  step's critical path: the negatives (``to_training_arrays``), hot-set
  staging (``SemanticCache.plan(background=True)``), the plan compile
  (``PooledExecutor.prepare``) and the copies to the card. Its queue holds
  ``PreparedWorkItem``\\ s whose tensors already lie on the card, so the main
  thread only launches the step's kernels.

On CUDA the scheduler thread owns a side stream and copies only there: every
item's integers (bind arrays, ``pos``/``neg`` in plan order, the static slot
arrays when their structure is new) are packed into one pinned host buffer
and copied without blocking, and an event marks the copies' end. No kernel
runs on the side stream. The main thread makes its current stream wait on
the event and marks the tensors as used there (``PreparedWorkItem.ready``)
before the step's first launch. On the CPU there is nothing to overlap, and
the item's tensors are plain views of host arrays.

``batch_entity_ids`` is the set of entity ids one step gathers semantic rows
for, which the hot set must hold before the step dispatches.

Straggler mitigation: several producers feed one queue; a slow producer (a
pathological rejection-sampling streak) cannot stall training because
consumption order is whoever-finishes-first, and a watchdog starts another
producer when the queue has starved past a deadline.
"""
from __future__ import annotations

import dataclasses
import queue
import threading
import time
from typing import TYPE_CHECKING, Callable, List, Optional

import numpy as np
import torch

from repro_torch.core.compile_cache import CompileCache
from repro_torch.core.plan import packed_to_device
from repro_torch.obs.registry import get_registry
from repro_torch.obs.trace import TRACER

if TYPE_CHECKING:
    from repro_torch.sampling.online import OnlineSampler, SampledQuery


class BatchPrefetcher:
    """``workers`` sampling threads, each with its own RNG stream, filling a
    queue of ``depth`` raw batches. ``close()`` stops and joins them."""

    def __init__(
        self,
        sampler: OnlineSampler,
        batch_size: int,
        depth: int = 2,
        workers: int = 2,
        deadline_s: float = 30.0,
    ):
        self.sampler = sampler
        self.batch_size = batch_size
        self.deadline_s = deadline_s
        self._q: "queue.Queue[List[SampledQuery]]" = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._lock = threading.Lock()
        self._last_progress = time.monotonic()
        self.restarts = 0
        self._threads = [
            threading.Thread(target=self._produce, args=(i,), daemon=True)
            for i in range(workers)
        ]
        for t in self._threads:
            t.start()
        self._watchdog = threading.Thread(target=self._watch, daemon=True)
        self._watchdog.start()

    def _produce(self, worker_id: int) -> None:
        # Each worker gets an independent RNG stream so batches differ.
        # Imported here: the sampler imports core, whose import reaches this
        # module through data/__init__.
        from repro_torch.sampling.online import OnlineSampler

        TRACER.set_lane(f"sampling worker {worker_id}")
        local = OnlineSampler(
            self.sampler.kg,
            patterns=self.sampler.patterns,
            seed=hash((id(self), worker_id)) % (2**31),
            max_rejects=self.sampler.max_rejects,
            max_answers=self.sampler.max_answers,
        )
        while not self._stop.is_set():
            try:
                with TRACER.span("sample", n=self.batch_size):
                    batch = local.sample_batch(self.batch_size)
            except RuntimeError:
                continue  # rejection streak: drop and retry (straggler-safe)
            while not self._stop.is_set():
                try:
                    self._q.put(batch, timeout=0.25)
                    with self._lock:
                        self._last_progress = time.monotonic()
                    break
                except queue.Full:
                    continue

    def _watch(self) -> None:
        """Start another producer if the queue has starved past the deadline."""
        while not self._stop.wait(self.deadline_s / 4):
            with self._lock:
                starved = (
                    self._q.empty()
                    and time.monotonic() - self._last_progress > self.deadline_s
                )
            if starved:
                self.restarts += 1
                t = threading.Thread(
                    target=self._produce, args=(len(self._threads) + self.restarts,),
                    daemon=True,
                )
                t.start()
                self._threads.append(t)
                with self._lock:
                    self._last_progress = time.monotonic()

    def next(self, timeout: float = 120.0) -> List[SampledQuery]:
        return self._q.get(timeout=timeout)

    def threads(self) -> List[threading.Thread]:
        """Every thread this prefetcher started (workers and the watchdog)."""
        return [*self._threads, self._watchdog]

    def close(self, timeout: float = 5.0) -> None:
        """Stop the workers and the watchdog and join them (each finishes the
        batch it is sampling), within ``timeout`` seconds."""
        self._stop.set()
        deadline = time.monotonic() + timeout
        for t in self.threads():
            while t.is_alive() and time.monotonic() < deadline:
                try:
                    while True:
                        self._q.get_nowait()
                except queue.Empty:
                    pass
                t.join(timeout=0.02)


def batch_entity_ids(queries, pos: np.ndarray, neg: np.ndarray) -> np.ndarray:
    """Every entity id one training step gathers semantic rows for: query
    anchors (EMBED pools) plus the positive/negative score candidates. This
    is the set the semantic hot-set cache must have staged before dispatch."""
    return np.concatenate(
        [np.asarray(q.anchors).ravel() for q in queries]
        + [np.asarray(pos).ravel(), np.asarray(neg).ravel()])


def rank_slice(ctx, queries, pos: np.ndarray, neg: np.ndarray) -> tuple:
    """This rank's share of a global batch under a mesh ``ctx``: ``(rows,
    queries, pos, neg, order)`` — its rows (``ctx.batch_rows``), their
    queries, positives and negatives, and the global batch's canonical
    order (the order a single-device plan of the whole batch puts its
    queries in, which the trainer gathers per-query losses into).
    Single-device: every row, and no order (the plan's own is it)."""
    if not ctx.is_sharded:
        return np.arange(len(queries)), queries, pos, neg, None
    rows = ctx.batch_rows(len(queries))
    order = np.asarray(sorted(range(len(queries)), key=lambda i: queries[i].key()),
                       dtype=np.int64)
    return rows, [queries[i] for i in rows], pos[rows], neg[rows], order


@dataclasses.dataclass
class PreparedWorkItem:
    """One fully host-scheduled training step, ready for dispatch.

    ``pos``/``neg`` are already permuted into the plan's canonical
    (pattern-sorted) order, and ``steps``/``ans``/``pos``/``neg`` already lie
    on the executor's device. Under a mesh the plan and tensors are this
    rank's ``rows`` of the global batch, ``n_queries`` counts the global
    batch, and ``patterns`` follow its canonical order ``global_order``. On CUDA they were copied on the scheduler
    thread's side stream: ``event`` marks the copies' end, ``buffers`` are
    the device buffers they wrote (the views above point into them), and
    ``host`` the pinned buffers they read, kept for the item's life. Call
    ``ready()`` on the thread that launches the step before the first use."""

    prepared: object            # repro_torch.core.plan.CompiledPlan
    steps: List[dict]           # slot/bind tensors per pool step
    ans: torch.Tensor           # answer slots
    pos: torch.Tensor           # [B] positives, canonical order
    neg: torch.Tensor           # [B, K] negatives, canonical order
    patterns: List[str]         # canonical order, for adaptive sampling
    n_queries: int
    rows: Optional[np.ndarray] = None          # mesh: this rank's rows
    global_order: Optional[np.ndarray] = None  # mesh: the batch's canonical order
    sem_stage: object = None    # semantic.store.SemStage planned on the
    #                             scheduler thread; the main thread applies
    #                             it right before this item's dispatch
    mat_hits: int = 0           # queries with a materialized row resident at
    mat_version: int = -1       # this cache version when the item was staged
    phases: dict = dataclasses.field(default_factory=dict)
    #                             scheduler-thread phase wall times (seconds):
    #                             negatives_s/sem_prefetch_s/schedule_s/
    #                             transfer_s (+ sample_s added by the
    #                             prefetcher)
    event: Optional[torch.cuda.Event] = None
    buffers: tuple = ()
    host: tuple = ()

    def ready(self) -> None:
        """Make the current stream wait for the side stream's copies, and
        mark their buffers as used on it, so the caching allocator does not
        hand them back to the side stream while this stream's kernels may
        still read them. A no-op on the CPU."""
        if self.event is None:
            return
        current = torch.cuda.current_stream(self.pos.device)
        current.wait_event(self.event)
        for t in self.buffers:
            t.record_stream(current)


def prepare_work_item(sampler, executor, batch, n_negatives: int,
                      dev_static=None, sem_cache=None, ctx=None,
                      stream=None, mat_cache=None) -> PreparedWorkItem:
    """Run the full host side of one training step: the negatives, hot-set
    staging, the plan compile (canonicalize → CSE → Algorithm-1 lowering,
    ``executor.prepare``) and the copies to the executor's device — the
    scheduler thread ships fully compiled plans, so the main thread only
    dispatches.

    ``dev_static`` (optional, a ``CompileCache``) caches the device copies of
    the static slot arrays by STRUCTURE key — under CSE that is the deduped
    topology, so they never change between batches sharing a post-CSE shape
    and copy once instead of once per step. The structure key is essential:
    the coarser signature only encodes bucketed shapes, and two different
    structures (e.g. 5 vs 6 queries padding to the same buckets) may share a
    signature while having different slot/answer arrays.

    ``sem_cache`` (optional, a ``semantic.store.SemanticCache``): the batch's
    entity ids are planned HERE (``plan(background=True)``): the missing rows
    are read from the store and copied while the previous batch executes, and
    the main thread applies the stage right before this batch dispatches.

    ``mat_cache`` (a ``core.matcache.MaterializedSubqueryCache``) is probed
    HERE: the item records how many of the batch's queries have a row
    resident at the current version (``mat_hits``/``mat_version``). Training
    never consumes those rows.

    ``stream``: on a CUDA executor, the side stream every copy goes on
    (required there; module docstring).

    ``ctx`` (a mesh ``ExecutionContext``): every rank draws the negatives of
    the whole global batch (the same on every rank, from the same sampler
    seed), stages the global batch's entity ids into its replicated hot set,
    and compiles the plan of its own rows only (``rank_slice``). No
    collective runs here: this is the scheduler thread.
    """
    device = executor.device
    if device.type == "cuda" and stream is None:
        raise ValueError("prepare_work_item on CUDA needs the side stream it "
                         "copies on")
    # Per-phase wall times, always collected (a perf_counter pair each).
    phases = {}
    t0 = time.perf_counter()
    queries, pos, neg = sampler.to_training_arrays(batch, n_negatives)
    phases["negatives_s"] = time.perf_counter() - t0
    sem_stage = None
    if sem_cache is not None:
        t0 = time.perf_counter()
        with TRACER.span("sem_prefetch", n=len(queries)):
            sem_stage = sem_cache.plan(batch_entity_ids(queries, pos, neg),
                                       background=True, stream=stream)
        phases["sem_prefetch_s"] = time.perf_counter() - t0
    mat_hits, mat_version = 0, -1
    if mat_cache is not None:
        mat_version = mat_cache.version
        mat_hits = mat_cache.probe([q.key() for q in queries], version=mat_version)
    n_global, patterns, rows, global_order = len(queries), None, None, None
    if ctx is not None and ctx.is_sharded:
        rows, local, pos, neg, global_order = rank_slice(ctx, queries, pos, neg)
        patterns = [queries[i].pattern for i in global_order]
        queries = local
    t0 = time.perf_counter()
    with TRACER.span("schedule", n=len(queries)):
        prepared = executor.prepare(queries)
    phases["schedule_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    # On CUDA this span is the enqueue of the side stream's copies, not their
    # completion (``event`` marks that).
    with TRACER.span("transfer", n_steps=len(prepared.bind_arrays)):
        buffers, host = [], []
        static = (dev_static.get(prepared.structure_key)
                  if dev_static is not None else None)
        if static is None:
            arrays = [a for s in prepared.slot_arrays for a in s.values()]
            views, flat, pinned = packed_to_device(
                arrays + [prepared.answer_slots], device, stream)
            it = iter(views)
            static = ([{k: next(it) for k in s} for s in prepared.slot_arrays],
                      next(it), flat)
            if dev_static is not None:
                dev_static.put(prepared.structure_key, static)
            host.append(pinned)
        slot_dev, ans, static_flat = static
        binds = [a for b in prepared.bind_arrays for a in b.values()]
        views, flat, pinned = packed_to_device(
            binds + [pos[prepared.order], neg[prepared.order]], device, stream)
        it = iter(views)
        steps = [{**s, **{k: next(it) for k in b}}
                 for s, b in zip(slot_dev, prepared.bind_arrays)]
        pos_dev, neg_dev = next(it), next(it)
        buffers += [static_flat, flat]
        host.append(pinned)
        event = None
        if stream is not None:
            event = torch.cuda.Event()
            event.record(stream)
    phases["transfer_s"] = time.perf_counter() - t0
    return PreparedWorkItem(
        prepared=prepared,
        steps=steps,
        ans=ans,
        pos=pos_dev,
        neg=neg_dev,
        patterns=prepared.patterns if patterns is None else patterns,
        n_queries=n_global,
        rows=rows,
        global_order=global_order,
        sem_stage=sem_stage,
        mat_hits=mat_hits,
        mat_version=mat_version,
        phases=phases,
        event=event,
        buffers=tuple(buffers),
        host=tuple(host),
    )


class PreparedBatchPrefetcher:
    """Background-thread prefetch queue feeding the Algorithm-1 scheduler.

    A single scheduler thread pulls raw batches (from an internal
    ``BatchPrefetcher``, or from ``batch_fn`` when the caller controls the
    workload — a fixed batch list, or adaptive sampling with the latest π)
    and turns each into a ``PreparedWorkItem`` (``prepare_work_item``).

    One scheduler thread by design: ``executor.prepare`` mutates the
    executor's schedule and plan caches (a single producer makes that
    race-free without locking the hot path), the sampler's RNG draws the
    negatives in batch order (so a pipelined run draws the same negatives as
    a sync one), and under the GIL extra host threads mostly add handoff
    latency. On CUDA the thread owns the side stream (``stream``) that every
    copy of its items goes on.

    Telemetry: the registry group ``pipeline`` holds the ``prepared_q_depth``
    gauge and ``phase_seconds{phase=sample|negatives|sem_prefetch|schedule|
    transfer}``; the thread's trace lane is "pipeline scheduler" (spans
    ``sample``, ``sem_prefetch``, ``schedule``, ``transfer``; the
    ``prepared_q_depth`` counter), the sampling workers' "sampling worker i"
    (``sample``). An error in the thread surfaces on ``next()`` as
    ``RuntimeError("prepared-batch prefetcher failed")``; ``close()`` returns
    within 5 s.

    ``ctx`` (a mesh): each item is this rank's slice of the global batch
    (``prepare_work_item(ctx=)``); the thread issues no collective.
    """

    def __init__(
        self,
        sampler: OnlineSampler,
        executor,
        batch_size: int,
        n_negatives: int,
        depth: int = 2,
        workers: int = 2,
        batch_fn: Optional[Callable[[], List[SampledQuery]]] = None,
        sem_cache=None,
        ctx=None,
        mat_cache=None,
    ):
        self.ctx = ctx
        self.sampler = sampler
        self.executor = executor
        self.n_negatives = n_negatives
        self.sem_cache = sem_cache
        self.mat_cache = mat_cache
        device = executor.device
        self.stream = torch.cuda.Stream(device) if device.type == "cuda" else None
        self._q: "queue.Queue[PreparedWorkItem]" = queue.Queue(maxsize=max(depth, 1))
        self._stop = threading.Event()
        self._error: Optional[BaseException] = None
        self._batches: Optional[BatchPrefetcher] = None
        if batch_fn is None:
            self._batches = BatchPrefetcher(sampler, batch_size, depth=depth,
                                            workers=workers)
            self._next_batch = self._sampled
        else:
            self._next_batch = batch_fn
        # Device copies of the static slot arrays, by structure key. LRU so
        # an unbounded signature stream cannot grow device memory unboundedly.
        self._dev_static = CompileCache(128, name="dev_static")
        self._metrics = get_registry().group("pipeline")
        self._depth_gauge = self._metrics.gauge("prepared_q_depth")
        self._phase_s = {
            name: self._metrics.counter("phase_seconds", phase=name)
            for name in ("sample", "negatives", "sem_prefetch", "schedule",
                         "transfer")}
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _sampled(self) -> Optional[List[SampledQuery]]:
        """The sampling workers' next batch, waited for in short slices so
        that ``close()`` ends this thread promptly (None once it has)."""
        while not self._stop.is_set():
            try:
                return self._batches.next(timeout=0.25)
            except queue.Empty:
                continue
        return None

    def _run(self) -> None:
        TRACER.set_lane("pipeline scheduler")
        if self.stream is not None:
            with torch.cuda.device(self.stream.device):
                self._loop()
        else:
            self._loop()

    def _loop(self) -> None:
        while not self._stop.is_set():
            try:
                t0, c0 = time.perf_counter(), time.thread_time()
                # Raw-batch acquisition: the sampling itself when batch_fn
                # runs inline, the wait on the workers' queue otherwise (their
                # own lanes carry the sampling spans).
                with TRACER.span("sample"):
                    batch = self._next_batch()
                if batch is None:
                    return
                sample_s = time.perf_counter() - t0
                item = prepare_work_item(self.sampler, self.executor, batch,
                                         self.n_negatives, self._dev_static,
                                         sem_cache=self.sem_cache,
                                         ctx=self.ctx, stream=self.stream,
                                         mat_cache=self.mat_cache)
                item.phases["sample_s"] = sample_s
                # This thread's CPU time for the item: with the main thread's
                # dispatch_cpu_s, what the two threads ask of one GIL.
                item.phases["scheduler_cpu_s"] = time.thread_time() - c0
                for name, c in self._phase_s.items():
                    c.inc(item.phases.get(name + "_s", 0.0))
            except Exception as e:  # surfaced on the consumer side
                if self._error is None:
                    self._error = e
                self._stop.set()
                return
            while not self._stop.is_set():
                try:
                    self._q.put(item, timeout=0.25)
                    self._depth_gauge.set(self._q.qsize())
                    if TRACER.enabled:
                        TRACER.counter("prepared_q_depth", depth=self._q.qsize())
                    break
                except queue.Full:
                    continue

    def next(self, timeout: float = 120.0) -> PreparedWorkItem:
        while True:
            if self._error is not None:
                raise RuntimeError("prepared-batch prefetcher failed") from self._error
            try:
                return self._q.get(timeout=0.25)
            except queue.Empty:
                timeout -= 0.25
                if timeout <= 0:
                    raise

    def close(self) -> None:
        self._stop.set()
        if self._batches is not None:
            self._batches.close()
        # Keep draining while joining: the scheduler thread may be blocked in
        # a queue.put, and taking items is what wakes it immediately.
        deadline = time.monotonic() + 5.0
        while self._thread.is_alive() and time.monotonic() < deadline:
            try:
                while True:
                    self._q.get_nowait()
            except queue.Empty:
                pass
            self._thread.join(timeout=0.02)
