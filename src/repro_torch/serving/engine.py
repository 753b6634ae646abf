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
  remain. With a ``mat_cache`` (``core/matcache.py``) the reuse goes
  CROSS-batch: the batcher gathers cached rows before padding, encodes only
  the misses, and inserts them (version-stamped, invalidated on
  ``update_params`` and graph writes).
* **Live graph** (``kg=``) — the engine follows the graph's
  ``graph_version``, retains the params (and the entity count) live at each
  recent version, and serves a request pinned to a version
  (``submit(pin_version=)``) on that version's params with version-keyed
  plan and materialized rows, or sheds it with ``StaleVersionError`` past
  ``max_staleness_versions``.
* **Hot swap** (``pin_params_on_admit``) — every request is served on the
  params current at its admission, even if ``update_params`` lands while it
  queues; batches are grouped by params version.
* **Under a mesh** — rank 0 admits, batches and takes writes; every batch,
  write, fine-tune, swap and close goes through the mesh's ``MeshLane`` as
  one typed message, and every rank does it at that point of the lane's
  order, so the state that decides a collective (retained params, views,
  caches, graph versions) changes in one order on every rank.
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

Entity counts: ``score_all`` masks table rows past the real entity count,
which live entity growth advances. The engine keeps the count beside every
params snapshot it retains and scores with it, so a version-pinned replay
after growth masks exactly as it did when the version was admitted.

Telemetry: registry counters under ``serving`` (``obs_labels`` label them),
and, while ``obs.TRACER`` is enabled, one async ``request`` span a request,
opened at admission and closed on whatever thread ends it (served, with
``latency_ms``; shed; rejected at a full queue; failed), so coalesced
duplicates keep distinct spans; the batcher's lane "<name> batcher" with the
spans ``batch`` (its requests' ``trace_ids``), ``sem_prefetch``, ``encode``,
``score`` and ``select``, and the ``serving_queue_depth`` counter. A
registry-wide ``reset()`` re-baselines the engine's derived deltas
(``_rebaseline``).
"""
from __future__ import annotations

import contextlib
import dataclasses
import pickle
import queue
import sys
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
from repro_torch.distributed.context import ExecutionContext
from repro_torch.obs.registry import get_registry
from repro_torch.obs.trace import TRACER
from repro_torch.serving.loadgen import latency_summary


class StaleVersionError(RuntimeError):
    """A version-pinned request fell outside the engine's staleness bound.

    Raised synchronously by ``submit`` when the pin is already out of bound
    (or no longer retained) at admission, and set on the future when writes
    land while the request is queued. Typed so clients can distinguish
    load-shedding from real failures and re-submit unpinned (or re-pin to
    ``engine.graph_version``)."""

    def __init__(self, pinned: int, current: int, bound: int):
        super().__init__(
            f"graph version {pinned} is stale: current {current}, "
            f"max_staleness_versions {bound}")
        self.pinned = pinned
        self.current = current
        self.bound = bound


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

    ``traces`` counts the distinct (batch size, dtype, table rows)
    signatures the scorer has been called with — the eager counterpart of
    the reference's jit trace count, so a replayed pow2-bucketed workload
    keeps it flat. ``n_entities`` is passed through to ``score_all``.

    Under a mesh ``ctx`` the params hold this rank's block of entity rows
    (``ctx.row_axes``): the scorer scores the whole batch against its rows
    and one all-gather over the row axes makes the [B, E] scores, the same
    on every rank (the reference pins its jit's logits replicated). The
    table is never whole on a rank. Collective under a mesh."""

    def __init__(self, model, ctx=None):
        self._model = model
        self._ctx = ctx if ctx is not None and ctx.is_sharded else None
        # The parameter views this mesh serves with, shared by the engine
        # and ``serve_batch`` as the scorer is.
        self.mesh = MeshServing(model, ctx) if self._ctx is not None else None
        self._seen = set()
        self._lock = threading.Lock()

    def _first_row(self, params) -> int:
        """The global id of this rank's first entity row."""
        return self._ctx.mesh.index(self.mesh.axes) * params["entity"].shape[0]

    @torch.no_grad()
    def __call__(self, params, q, n_entities: Optional[int] = None):
        sig = (q.shape[0], q.dtype, params["entity"].shape[0])
        with self._lock:
            self._seen.add(sig)
        if self._ctx is None:
            return self._model.score_all(params, q, n_entities=n_entities)
        local = self._model.score_all(params, q, n_entities=n_entities,
                                      row_offset=self._first_row(params))
        return self._ctx.gather_blocks(local, self.mesh.axes, dim=1)

    @torch.no_grad()
    def chunked(self, params, q, sem_rows_fn) -> np.ndarray:
        """``model.score_all_chunked`` (out of core): under a mesh each rank
        streams the chunks of its own rows from the store and one all-gather
        makes the [B, n_real] scores."""
        if self._ctx is None:
            return self._model.score_all_chunked(params, q, sem_rows_fn)
        lo = self._first_row(params)
        rows = params["entity"].shape[0]
        n_real = self._model.n_entities
        hi = max(lo, min(lo + rows, n_real))
        local = self._model.score_rows_chunked(params, q, sem_rows_fn, lo, hi,
                                               row_offset=lo)
        if hi - lo < rows:   # this block's padding rows: never in the top-k
            local = torch.cat([local, local.new_full((q.shape[0], rows - (hi - lo)),
                                                     -1e30)], dim=1)
        return self._ctx.gather_blocks(local, self.mesh.axes,
                                       dim=1)[:, :n_real].cpu().numpy()

    @property
    def traces(self) -> int:
        return len(self._seen)


_SCORER_LOCK = threading.Lock()


def scorer_for(model, ctx=None) -> CachedScorer:
    """The scorer cached on ``model`` (per ``ctx.describe()`` under a mesh):
    the engine and ``serve_batch`` resolve the same object, so their scores
    come from one code path and share one signature count."""
    key = ctx.describe() if ctx is not None and ctx.is_sharded else None
    with _SCORER_LOCK:
        cache = model.__dict__.setdefault("_cached_scorers", {})
        s = cache.get(key)
        if s is None:
            s = cache[key] = CachedScorer(model, ctx)
    return s


class MeshServing:
    """The parameters one rank serves with under a mesh ``ctx``.

    * ``view(params)`` — every parameter whole, gathered once per params
      set (``ctx.gather``), except the entity table (and a resident
      ``sem_table``), which stay this rank's block of rows; the hot set
      (``sem_cache``/``sem_slot``) is replicated and shared. Collective the
      first time a params set is seen. The tables' whole shapes are read
      off the params (their block times the row axes' ways), so the views
      of a version retained from before an entity growth stay right after
      it; the row axes themselves never change (a growth that would change
      them is refused).
    * ``encode_params(view, queries)`` — the view with the entity rows of
      the batch's anchors (``ctx.fetch_rows``: each from its owner, bitwise)
      and their sorted ids under ``entity_ids``, which the model's
      ``fused_entity_vec`` looks ids up in. Collective, once per batch.

    So the encode sees exactly the single-device rows, and the table as a
    whole is never on a rank."""

    _RETAIN = 4

    def __init__(self, model, ctx):
        self.model = model
        self.ctx = ctx
        self.axes = ctx.row_axes("entity", model.full_shapes["entity"])
        self._views: Dict[int, Tuple[object, Dict]] = {}

    def view(self, params) -> Dict[str, torch.Tensor]:
        hit = self._views.get(id(params))
        if hit is not None and hit[0] is params:
            return hit[1]
        shapes = self.model.full_shapes
        out = {}
        for k in sorted(params):
            if k == "entity":
                out[k] = params[k]
            elif k == "sem_table":
                out[k] = self._block_rows(k, params[k], params["entity"])
            else:
                out[k] = self.ctx.gather(k, params[k], shapes[k])
        self._views[id(params)] = (params, out)
        while len(self._views) > self._RETAIN:
            del self._views[next(iter(self._views))]
        return out

    def _block_rows(self, name, local, entity) -> torch.Tensor:
        """``name``'s rows of this rank's entity block: its own shard where
        its rule splits rows as the entity table's does, else those rows cut
        from the gathered table (padded to the entity rows, as it is)."""
        n = entity.shape[0]
        rows = n * self.ctx.mesh.ways(self.axes)
        shape = (rows, self.model.full_shapes[name][1])
        if self.ctx.param_spec(name, shape) == self.ctx.param_spec(
                "entity", (rows, entity.shape[1])):
            return local
        lo = self.ctx.mesh.index(self.axes) * n
        return self.ctx.gather(name, local, shape)[lo:lo + n].clone()

    def reset(self) -> None:
        """Drop every view (after an entity growth: the next batch gathers
        afresh). Every rank calls it at the same point of the lane."""
        self._views.clear()

    def encode_params(self, view, queries: Sequence[QueryInstance]) -> Dict:
        ids = np.unique(np.concatenate([np.asarray(q.anchors, dtype=np.int64)
                                        for q in queries]))
        out = dict(view)
        out["entity"] = self.ctx.fetch_rows(view["entity"], self.axes, ids)
        if "sem_table" in view:
            out["sem_table"] = self.ctx.fetch_rows(view["sem_table"], self.axes, ids)
        out["entity_ids"] = torch.as_tensor(ids, device=view["entity"].device)
        return out


class MeshLane:
    """The one ordered lane of a mesh's serving collectives, and of all that
    changes what they do.

    Rank 0 alone admits requests, forms micro-batches (its batchers' time
    decides them) and takes graph writes. For each thing every rank must do
    it broadcasts one typed message, and every rank does it at that point
    of the order, collectives and all:

    * ``batch`` — a micro-batch's composition: its requests' queries and
      ``top_k``, its graph-version pin and its admitted params version (the
      retained snapshot it is served from);
    * ``write`` — a ``LiveNGDB`` write: its triples, ``n_new_entities`` and
      ``sem_rows``;
    * ``finetune`` — the background fine-tune of the write committed at a
      graph version, with its seed: every rank runs it (collective) and
      publishes its result as a swap;
    * ``swap`` — an ``update_params`` call, by its sequence number on that
      engine;
    * ``close`` — an engine closed; once all have, the others stop following.

    Ranks other than 0 run no batcher: ``follow()`` receives the messages
    and does them in the order sent. Every engine of one mesh shares the
    lane, so rank 0's batchers, writer and maintenance thread take turns
    under ``lock`` (always taken before an engine's own lock) and one
    process group carries every collective in one order on every rank. An
    engine's lane id is its place in the order the rank built the lane's
    engines, the same on every rank. ``hold_s`` keeps how long rank 0 held
    the lane for each write, fine-tune and swap."""

    _LANES: Dict[int, "MeshLane"] = {}
    _GUARD = threading.Lock()

    @classmethod
    def of(cls, ctx) -> "MeshLane":
        with cls._GUARD:
            lane = cls._LANES.get(id(ctx.mesh))
            if lane is None or lane.ctx.mesh is not ctx.mesh:
                lane = cls._LANES[id(ctx.mesh)] = cls(ctx)
            return lane

    def __init__(self, ctx):
        self.ctx = ctx
        self.lock = threading.RLock()
        self._engines: Dict[int, "ServingEngine"] = {}
        self._next_id = 0
        self.hold_s: Dict[str, List[float]] = {"write": [], "finetune": [], "swap": []}

    def register(self, engine) -> int:
        with self.lock:
            lane_id = self._next_id
            self._next_id += 1
            self._engines[lane_id] = engine
            return lane_id

    def _broadcast(self, payload: Optional[bytes]) -> bytes:
        mesh, dev = self.ctx.mesh, self.ctx.device
        axes = mesh.axis_names
        n = torch.tensor([0 if payload is None else len(payload)], dtype=torch.int64,
                         device=dev)
        mesh.broadcast(n, 0, axes)
        size = int(n.item())
        buf = (torch.frombuffer(bytearray(payload), dtype=torch.uint8).to(dev)
               if payload is not None else torch.empty(size, dtype=torch.uint8, device=dev))
        mesh.broadcast(buf, 0, axes)
        return buf.cpu().numpy().tobytes()

    @contextlib.contextmanager
    def held(self, kind: str):
        """Rank 0: hold the lane for one write, fine-tune or swap (timed)."""
        with self.lock:
            t0 = time.perf_counter()
            try:
                yield
            finally:
                self.hold_s[kind].append(time.perf_counter() - t0)

    def announce(self, kind: str, lane_id: int, payload) -> None:
        """Rank 0, holding ``lock``: send one message."""
        if lane_id not in self._engines:
            raise RuntimeError(f"engine {lane_id} of the lane is closed: no rank would "
                               f"follow its {kind}")
        self._broadcast(pickle.dumps((kind, lane_id, payload)))

    def announce_batch(self, lane_id: int, flush: str, batch: Sequence) -> None:
        """Rank 0, holding ``lock``: send one batch's composition."""
        reqs = [(r.query.pattern, np.asarray(r.query.anchors),
                 np.asarray(r.query.relations), r.top_k) for r in batch]
        self.announce("batch", lane_id, (flush, reqs, batch[0].pin_version,
                                         batch[0].params_version))

    def release(self, lane_id: int) -> None:
        """An engine closed; on rank 0, tell the other ranks."""
        with self.lock:
            if self._engines.pop(lane_id, None) is None:
                return
            if self.ctx.rank == 0:
                self._broadcast(pickle.dumps(("close", lane_id, None)))

    def follow(self) -> int:
        """Ranks other than 0: do every message rank 0 sends, in order, until
        all its engines have closed. Returns the number of batches served."""
        n = 0
        while self._engines:
            kind, lane_id, payload = pickle.loads(self._broadcast(None))
            if kind == "close":
                self._engines.pop(lane_id, None)
                continue
            self._engines[lane_id]._on_lane(kind, payload)
            n += kind == "batch"
        return n


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
    # Staleness-bounded serving (needs ``kg=``): a version-pinned request is
    # served from its pinned version's params as long as the live graph is
    # at most this many versions ahead; beyond the bound it is SHED with a
    # typed StaleVersionError. 0 = pinned requests only survive until the
    # next write.
    max_staleness_versions: int = 0
    # Hot-swap semantics: every request is stamped with the params version
    # current at ADMISSION and served on exactly those params even if
    # ``update_params`` lands while it queues (the replica tier's contract).
    pin_params_on_admit: bool = False


# Errors a request's own query raises (a malformed pattern is a KeyError):
# every rank of a mesh meets them on the same batch.
_QUERY_ERRORS = (KeyError, ValueError)


@dataclasses.dataclass
class _Request:
    query: QueryInstance
    top_k: int
    future: Future
    t_submit: float
    # Pinned graph version (None = the version current at execute time).
    pin_version: Optional[int] = None
    # Params version current at admission (``pin_params_on_admit`` only).
    params_version: int = 0
    # Async ``request`` span id (0 = not traced).
    trace_id: int = 0


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
    params_version: int = 0        # the params it ran on (pin_params_on_admit)


class ServingEngine:
    """Async continuous-batching NGDB query service on ``device`` (``cuda``
    unless given).

    ``submit`` is thread-safe and returns a future; a single batcher thread
    coalesces pending requests into pooled micro-batches and resolves the
    futures. ``sem_cache``/``sem_rows_fn`` switch on out-of-core serving:
    anchors stage into the hot set before encode, and all-entity scoring
    streams H_sem via ``sem_rows_fn`` (e.g. ``SemanticStore.read_rows``).
    ``mat_cache`` adds cross-batch row reuse, ``kg`` version-pinned serving
    against a live graph, ``cfg.pin_params_on_admit`` the hot-swap contract
    (module docstring). ``name`` labels the batcher thread; ``obs_labels``
    label every registry metric the engine publishes (replicas pass
    ``replica="0"`` etc.). ``latency_window`` overrides the config's
    percentile window (validated as ``>= 1``).

    Under a mesh ``ctx`` (``distributed/context.py``) ``params`` are this
    rank's shards (``init_params(ctx=)``) and the engine runs on
    ``ctx.device``. Every rank serves the same micro-batches and holds the
    same answers; rank 0 admits requests, forms the batches and replies,
    and the other ranks ``follow()`` it through the mesh's ``MeshLane``.
    The entity table stays split by rows: the encode fetches its anchors'
    rows (``MeshServing``) and the scorer gathers the [B, E] scores. With a
    live graph (``kg=``, each rank its own copy, written only through a
    ``LiveNGDB``) every write and fine-tune, and every ``update_params``
    (collective: each rank passes its shards), lands at one point of the
    lane's order on every rank."""

    # Under a mesh: how long a follower waits for its own ``update_params``
    # of a swap rank 0 announced before it raises.
    SWAP_WAIT_S = 60.0

    def __init__(self, model, params, executor=None,
                 cfg: Optional[ServingConfig] = None, device=None,
                 sem_cache=None, sem_rows_fn=None, started: bool = True,
                 mat_cache=None, kg=None, obs_labels: Optional[Dict[str, str]] = None,
                 name: Optional[str] = None, ctx=None, latency_window: Optional[int] = None):
        self.model = model
        self.params = params
        self.name = name or "serving"
        self.cfg = cfg or ServingConfig()
        if latency_window is not None:
            # Overrides the config's, for callers that build no ServingConfig.
            self.cfg = dataclasses.replace(self.cfg, latency_window=latency_window)
        if self.cfg.max_batch < 1 or self.cfg.queue_depth < 1:
            raise ValueError("max_batch and queue_depth must be >= 1")
        if self.cfg.latency_window < 1:
            raise ValueError("latency_window must be >= 1")
        self.ctx = ctx if ctx is not None else ExecutionContext.single_device()
        sharded = self.ctx.is_sharded
        self.device = resolve_device(self.ctx.device if device is None and sharded
                                     else device)
        self.executor = executor or PooledExecutor(model, b_max=256,
                                                   device=self.device, ctx=self.ctx)
        if self.executor.device != self.device:
            raise ValueError(f"executor runs on {self.executor.device}, the "
                             f"engine on {self.device}")
        if sem_cache is not None and sem_rows_fn is None:
            raise ValueError(
                "out-of-core serving needs sem_rows_fn (e.g. store.read_rows)"
                " to stream H_sem for all-entity scoring")
        self.sem_cache = sem_cache
        self.sem_rows_fn = sem_rows_fn
        # The engine owns the materialized-cache consult/insert; an executor
        # cache as well would count every miss twice.
        self.mat_cache = mat_cache
        if (mat_cache is not None
                and getattr(self.executor, "mat_cache", None) is not None):
            raise ValueError(
                "pass mat_cache to the engine OR the executor, not both")
        # Hot-set staging mutates a device buffer shared across params
        # snapshots, which version-pinned replay cannot coexist with.
        if kg is not None and sem_cache is not None:
            raise ValueError(
                "staleness-bounded serving (kg=...) does not support the "
                "out-of-core sem_cache hot set — pass one or the other")
        if self.cfg.max_staleness_versions < 0:
            raise ValueError("max_staleness_versions must be >= 0")
        if self.cfg.pin_params_on_admit and (kg is not None
                                             or sem_cache is not None):
            raise ValueError(
                "pin_params_on_admit does not compose with kg= or sem_cache=")
        self.kg = kg
        # Entity count scored with the live params (module docstring).
        self._n_entities = int(getattr(model, "n_entities",
                                       params["entity"].shape[0]))
        self._graph_version = kg.graph_version if kg is not None else -1
        self._version_retention = max(self.cfg.max_staleness_versions + 1, 4)
        # graph version -> (params, entity count) live at that version.
        self._version_params: Dict[int, Tuple[object, int]] = (
            {self._graph_version: (params, self._n_entities)}
            if kg is not None else {})
        if kg is not None:
            kg.add_invalidation_listener(self._on_kg_write)
        self._params_version = 0
        self._params_retention = 4
        self._params_by_version: Dict[int, Tuple[object, int]] = (
            {0: (params, self._n_entities)} if self.cfg.pin_params_on_admit else {})
        # Under a mesh: this engine's ``update_params`` calls so far, and a
        # follower's params staged for the swaps rank 0 has yet to announce.
        self._swap_seq = 0
        self._staged: Dict[int, object] = {}
        self._staged_cv = threading.Condition()
        # The LiveNGDB writing through this engine (its lane messages).
        self._live = None
        self._scorer = scorer_for(model, self.ctx)
        self._scorer_traces0 = self._scorer.traces
        self._sharing0 = dict(self.executor.sharing_stats())
        self._q: "queue.Queue" = queue.Queue(maxsize=self.cfg.queue_depth)
        # Unpack buffer for grouped admissions (``submit_many`` enqueues a
        # whole batch as ONE queue entry); owned by the batcher thread.
        self._pending: "deque[_Request]" = deque()
        self._stop = threading.Event()
        self._closed = False
        self._lock = threading.Lock()
        self._metrics = get_registry().group("serving", **(obs_labels or {}))
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
        # Requests shed for staleness (typed error, NOT failures) and served
        # counts by version lag (0 = current).
        self._stale_sheds = self._metrics.counter("stale_sheds")
        self._version_served: Dict[int, object] = {}
        self._graph_version_gauge = self._metrics.gauge("graph_version")
        self._graph_version_gauge.set(self._graph_version)
        # After a registry-wide reset() the derived deltas (scorer signatures,
        # sharing totals) must re-baseline or they would go negative; the hook
        # is held weakly, so a collected engine takes it along.
        get_registry().on_reset(self._rebaseline)
        self.batch_log: List[BatchRecord] = []
        self._thread: Optional[threading.Thread] = None
        self._mesh = self._scorer.mesh
        self._lane = MeshLane.of(self.ctx) if sharded else None
        self._lane_id = self._lane.register(self) if sharded else -1
        # Ranks other than 0 run no batcher: they follow rank 0's batches.
        self.leader = self.ctx.rank == 0
        if started and self.leader:
            self.start()

    def _rebaseline(self) -> None:
        """Registry-reset hook: zero the derived deltas that live outside the
        registry (scorer signatures, cumulative sharing totals)."""
        self._scorer_traces0 = self._scorer.traces
        self._sharing0 = dict(self.executor.sharing_stats())
        with self._lock:
            self._version_served = {}

    def _on_kg_write(self, reason: str) -> None:
        """Graph write listener (held weakly by the graph): advance the
        tracked version and retain the CURRENT params, with the model's
        current entity count, under it. Until maintenance publishes
        fine-tuned params through ``update_params``, the new version serves
        the old weights. Old versions age out of retention; a request pinned
        to an evicted version is shed."""
        with self._lock:
            if self.kg is None:
                return
            self._graph_version = self.kg.graph_version
            self._n_entities = int(self.model.n_entities)
            self._version_params[self._graph_version] = (self.params,
                                                         self._n_entities)
            while len(self._version_params) > self._version_retention:
                del self._version_params[min(self._version_params)]
        self._graph_version_gauge.set(self._graph_version)

    @property
    def graph_version(self) -> int:
        """The newest graph version this engine has observed (-1 when no
        ``kg`` is attached)."""
        with self._lock:
            return self._graph_version

    def params_at(self, version: int) -> Tuple[object, int]:
        """``(params, entity count)`` retained for graph ``version``; raises
        ``KeyError`` once it has aged out."""
        with self._lock:
            return self._version_params[version]

    # ------------------------------------------------------------ lifecycle
    def start(self) -> None:
        if not self.leader:
            raise RuntimeError(f"rank {self.ctx.rank} of {self.ctx.describe()} runs no "
                               "batcher: it follow()s rank 0")
        if self._thread is not None and self._thread.is_alive():
            return
        self._stop.clear()
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name=f"{self.name}-batcher")
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
        if self._lane is not None:
            self._lane.release(self._lane_id)

    def follow(self) -> int:
        """A rank other than 0 under a mesh: do rank 0's batches, writes,
        fine-tunes and swaps, in its order, until its engines close
        (``MeshLane.follow``). Returns the number of batches served."""
        if self._lane is None or self.leader:
            raise RuntimeError("follow() is for ranks other than 0 of a mesh")
        with self._lock:
            self._closed = True   # a follower admits nothing itself
        return self._lane.follow()

    def _on_lane(self, kind: str, payload) -> None:
        """A rank other than 0: do one message rank 0 sent (``MeshLane``).
        A write, fine-tune or swap that fails here failed on this rank alone
        (rank 0 checks a write before announcing it), after which its state
        and collectives would no longer pair with rank 0's: the error is
        counted, written to stderr and raised, ending ``follow()``."""
        if kind == "batch":
            self._follow(*payload)
            return
        try:
            if kind == "swap":
                self._follow_swap(payload)
            elif self._live is None:
                raise RuntimeError(f"rank 0 sent a {kind}, and no LiveNGDB writes through "
                                   "this rank's engine")
            elif kind == "write":
                self._live._apply_write(*payload)
            elif kind == "finetune":
                self._live._follow_finetune(*payload)
            else:
                raise ValueError(f"unknown lane message {kind!r}")
        except Exception as e:
            with self._lock:
                self._failures += 1
            print(f"[rank {self.ctx.rank}] {self.name}: a {kind} failed on this rank "
                  f"({type(e).__name__}: {e}); it stops following", file=sys.stderr)
            raise

    def _follow_swap(self, seq: int) -> None:
        """Apply this rank's params of swap ``seq`` (staged by its own
        ``update_params``), waiting up to ``SWAP_WAIT_S`` for them."""
        deadline = time.monotonic() + self.SWAP_WAIT_S
        with self._staged_cv:
            while seq not in self._staged:
                left = deadline - time.monotonic()
                if left <= 0:
                    raise TimeoutError(
                        f"swap {seq}: this rank's update_params for it did not come "
                        f"within {self.SWAP_WAIT_S} s")
                self._staged_cv.wait(left)
            params = self._staged.pop(seq)
        self._swap(params)

    def _follow(self, flush: str, reqs, pin_version: Optional[int] = None,
                params_version: int = 0) -> None:
        """Serve one batch rank 0 announced, as rank 0 serves it: on the
        snapshot of its graph-version pin and admitted params version, which
        this rank retains as rank 0 does (the same writes and swaps reached
        both in the same order).

        A query's own error (``_QUERY_ERRORS``, e.g. a malformed pattern) is
        the one rank 0 meets on the same inputs: it retries the requests
        alone and announces each retry, so this rank goes on, counting a
        failure where rank 0 does (a batch of one). Any other error may be
        this rank's alone (memory, a store read), after which its
        collectives would no longer pair with rank 0's: it is counted,
        written to stderr and raised, ending ``follow()``."""
        now = time.perf_counter()
        batch = [_Request(QueryInstance(p, a, r), k, Future(), now, pin_version,
                          params_version) for p, a, r, k in reqs]
        try:
            self._serve(batch, flush)
        except _QUERY_ERRORS as e:
            if len(batch) == 1:
                with self._lock:
                    self._failures += 1
            print(f"[rank {self.ctx.rank}] {self.name}: a batch of {len(batch)} failed "
                  f"({type(e).__name__}: {e}), as on rank 0", file=sys.stderr)
        except Exception as e:
            with self._lock:
                self._failures += len(batch)
            print(f"[rank {self.ctx.rank}] {self.name}: a batch of {len(batch)} failed "
                  f"on this rank ({type(e).__name__}: {e}); it stops following",
                  file=sys.stderr)
            raise

    def _fail_queued(self) -> None:
        try:
            while True:
                entry = self._q.get_nowait()
                for r in (entry if type(entry) is list else (entry,)):
                    if r.trace_id:
                        TRACER.async_end("request", r.trace_id, failed=True)
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
               timeout: Optional[float] = None,
               pin_version: Optional[int] = None) -> Future:
        """Admit one request. Blocks when the admission queue is full
        (bounded-memory backpressure); with ``timeout`` raises ``queue.Full``
        instead. The returned future resolves to the same result dict
        ``serve_batch`` produces, plus ``latency_ms``/``batch_size``.

        ``pin_version`` (needs ``kg=``) pins the request to one graph
        version: it is served from that version's retained params with
        version-keyed plan/materialized rows, or shed with
        ``StaleVersionError`` when the live graph has moved more than
        ``cfg.max_staleness_versions`` ahead (checked here and again at
        execute time, since writes can land while the request queues)."""
        self._check_leader()
        k = self.cfg.top_k if top_k is None else top_k
        if k < 1:
            raise ValueError(f"top_k must be >= 1, got {k}")
        if pin_version is not None:
            if self.kg is None:
                raise ValueError(
                    "pin_version needs a live graph: construct the engine "
                    "with kg=...")
            with self._lock:
                cur = self._graph_version
                if pin_version < 0 or pin_version > cur:
                    raise ValueError(
                        f"unknown graph version {pin_version} (current {cur})")
                if (cur - pin_version > self.cfg.max_staleness_versions
                        or pin_version not in self._version_params):
                    self._stale_sheds += 1
                    raise StaleVersionError(pin_version, cur,
                                            self.cfg.max_staleness_versions)
        with self._lock:
            if self._closed:
                raise RuntimeError("serving engine is closed")
            self._submitted += 1
            pv = self._params_version if self.cfg.pin_params_on_admit else 0
        trace_id = 0
        if TRACER.enabled:
            trace_id = TRACER.next_id()
            TRACER.async_begin("request", trace_id, pattern=query.pattern, top_k=k)
        r = _Request(query, k, Future(), time.perf_counter(), pin_version, pv,
                     trace_id)
        try:
            self._q.put(r, timeout=timeout)
        except queue.Full:
            with self._lock:
                self._submitted -= 1
            if trace_id:
                TRACER.async_end("request", trace_id, rejected=True)
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
        group share one admission timestamp and params version; the bounded
        queue counts a group as one entry. Graph-version pinning stays on
        the single-request path."""
        self._check_leader()
        if not queries:
            return []
        k = self.cfg.top_k if top_k is None else top_k
        if k < 1:
            raise ValueError(f"top_k must be >= 1, got {k}")
        with self._lock:
            if self._closed:
                raise RuntimeError("serving engine is closed")
            self._submitted += len(queries)
            pv = self._params_version if self.cfg.pin_params_on_admit else 0
        t0 = time.perf_counter()
        group = []
        for q in queries:
            trace_id = 0
            if TRACER.enabled:
                trace_id = TRACER.next_id()
                TRACER.async_begin("request", trace_id, pattern=q.pattern, top_k=k)
            group.append(_Request(q, k, Future(), t0, None, pv, trace_id))
        try:
            self._q.put(group, timeout=timeout)
        except queue.Full:
            with self._lock:
                self._submitted -= len(group)
            for r in group:
                if r.trace_id:
                    TRACER.async_end("request", r.trace_id, rejected=True)
            raise
        if self._stop.is_set():
            self._fail_queued()
        return [r.future for r in group]

    def _check_leader(self) -> None:
        if not self.leader:
            raise RuntimeError(f"rank {self.ctx.rank} of {self.ctx.describe()} admits "
                               "no requests: submit on rank 0")

    def queue_depth(self) -> int:
        """Entries waiting in the admission queue (the router's spill
        signal). A grouped admission counts as one entry until the batcher
        unpacks it."""
        return self._q.qsize()

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
        # Named at thread start, traced or not: the lane outlives enable().
        TRACER.set_lane(f"{self.name} batcher")
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
            if TRACER.enabled:
                TRACER.counter("serving_queue_depth", depth=self._q.qsize())
            self._execute(batch, flush)

    def _execute(self, batch: List[_Request], flush: str) -> None:
        batch = self._shed_stale(batch)
        if not batch:
            return
        # Pinned requests are served per pinned version (one params snapshot
        # and one cache keyspace a micro-batch); with pin_params_on_admit the
        # admitted params version splits the same way, so a swap landing
        # between dequeue and execute never mixes params in one batch.
        groups: Dict[Tuple, List[_Request]] = {}
        for r in batch:
            groups.setdefault((r.pin_version, r.params_version), []).append(r)
        for g in groups.values():
            self._execute_group(g, flush)

    def _shed_stale(self, batch: List[_Request]) -> List[_Request]:
        """Execute-time staleness re-check: writes that landed while a
        pinned request queued can push it out of bound. Shed requests fail
        with the typed error and count as ``stale_sheds`` — never as
        ``failures``, and never through the solo-retry path."""
        if self.kg is None:
            return batch
        with self._lock:
            cur = self._graph_version
            bound = self.cfg.max_staleness_versions
            keep: List[_Request] = []
            shed: List[_Request] = []
            for r in batch:
                if (r.pin_version is not None
                        and (cur - r.pin_version > bound
                             or r.pin_version not in self._version_params)):
                    shed.append(r)
                else:
                    keep.append(r)
            self._stale_sheds += len(shed)
            self._completed += len(shed)
        for r in shed:
            if r.trace_id:
                TRACER.async_end("request", r.trace_id, shed=True)
            r.future.set_exception(StaleVersionError(r.pin_version, cur, bound))
        return keep

    def _execute_group(self, batch: List[_Request], flush: str) -> None:
        # Exception, not BaseException: SystemExit/KeyboardInterrupt take
        # the batcher down rather than being swallowed into futures. Within
        # Exception, only recoverable per-request errors (e.g. malformed
        # pattern → KeyError) get poison isolation — MemoryError fails the
        # whole batch at once, never an N-fold solo-retry storm.
        try:
            with TRACER.span("batch", n=len(batch), flush=flush,
                             trace_ids=[r.trace_id for r in batch]):
                if self._lane is None:
                    results = self._serve(batch, flush)
                else:
                    # One batch at a time on the mesh: its composition, then
                    # its collectives, in the order every rank follows. Writes
                    # land only under the lane's lock, so the staleness check
                    # is made again under it, before the announcement.
                    with self._lane.lock:
                        batch = self._shed_stale(batch)
                        results = []
                        if batch:
                            self._lane.announce_batch(self._lane_id, flush, batch)
                            results = self._serve(batch, flush)
        except Exception as e:
            if isinstance(e, StaleVersionError):
                # The pin was evicted mid-batch by a concurrent write: a
                # deterministic shed, so no solo retry.
                for r in batch:
                    if r.trace_id:
                        TRACER.async_end("request", r.trace_id, shed=True)
                    r.future.set_exception(e)
                with self._lock:
                    self._stale_sheds += len(batch)
                    self._completed += len(batch)
                return
            if len(batch) > 1 and not isinstance(e, MemoryError):
                # Isolate the poison request: one malformed query must not
                # fail its co-batched neighbors.
                for r in batch:
                    self._execute([r], "retry")
                return
            for r in batch:
                # The span ends BEFORE the future resolves: a client that
                # writes the trace once its future is done sees no open span.
                if r.trace_id:
                    TRACER.async_end("request", r.trace_id, failed=True)
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
        for r, res, lat_ms in zip(batch, results, lats):
            if r.trace_id:
                TRACER.async_end("request", r.trace_id, latency_ms=lat_ms)
            r.future.set_result(res)

    def update_params(self, params) -> None:
        """Hot-swap the serving params (e.g. after an incremental
        fine-tune). The swap and the materialized-cache invalidation happen
        under ONE lock acquisition, so no batch observes new params with old
        rows: a batch that snapshotted before the swap finishes on the old
        params and its late inserts are dropped by the version check. With
        a live graph the new params (and the model's entity count) become
        the CURRENT graph version's snapshot; older pins keep theirs. With
        ``pin_params_on_admit`` requests already queued keep their admitted
        params.

        Under a mesh it is collective: every rank calls it with its own
        shards, in the same order (each rank's ``n``-th call is swap ``n``).
        Rank 0's call takes the lane, announces the swap and applies it, so
        it lands between the same two batches on every rank; another rank's
        call stages its params, which its ``follow()`` applies when swap
        ``n`` arrives, or raises, naming ``n``, if they have not come within
        ``SWAP_WAIT_S``."""
        if self._lane is None:
            self._swap(params)
        elif self.leader:
            with self._lane.held("swap"):
                self._swap_seq += 1
                self._lane.announce("swap", self._lane_id, self._swap_seq)
                self._swap(params)
        else:
            with self._staged_cv:
                self._swap_seq += 1
                self._staged[self._swap_seq] = params
                self._staged_cv.notify_all()

    def _swap(self, params) -> None:
        """``update_params`` on this rank alone: at a point of the lane's
        order under a mesh (a swap, a write's growth, a fine-tune)."""
        with self._lock:
            self.params = params
            self._n_entities = int(getattr(self.model, "n_entities",
                                           params["entity"].shape[0]))
            snap = (params, self._n_entities)
            if self.kg is not None:
                self._version_params[self._graph_version] = snap
            if self.cfg.pin_params_on_admit:
                self._params_version += 1
                self._params_by_version[self._params_version] = snap
                while len(self._params_by_version) > self._params_retention:
                    del self._params_by_version[min(self._params_by_version)]
            if self.mat_cache is not None:
                self.mat_cache.bump_version("param_update")

    def _states_for(self, params, uniq: List[QueryInstance],
                    padded: List[QueryInstance], n_real: int, mat_ver: int,
                    gv: int = -1, use_cache: bool = True) -> torch.Tensor:
        """Encoded states for the padded unique composition, gathering rows
        from the materialized cache where possible. The result is bitwise
        what ``executor.encode(params, padded)`` would return — pooled ops
        are row-wise, cached rows were such rows at the same version, and
        pad rows repeat the last unique row as ``pad_to_bucket``'s repeated
        query would.

        ``gv`` (the batch's graph version; -1 = no live graph) keys both the
        plan cache and the materialized rows, so rows encoded against
        different graph snapshots never alias within one cache version."""
        if self.mat_cache is None or not use_cache:
            # ``use_cache=False``: the batch runs on RETAINED (pre-swap)
            # params while the cache stamp tracks the current ones, so
            # neither its rows nor inserts from this batch would be valid.
            return self.executor.encode(params, padded, graph_version=gv)
        states = self.executor.encode_cached(params, uniq, self.mat_cache,
                                             mat_ver, graph_version=gv)
        if len(padded) > n_real:
            states = torch.cat([states, states[-1:].expand(len(padded) - n_real, -1)])
        return states

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
        # Snapshot (params, entity count, cache version, graph version)
        # together under the lock: ``update_params`` swaps and bumps under
        # the same lock, so a batch never pairs new params with rows
        # materialized under old ones. A pinned batch (one pin after
        # grouping) serves from the pinned version's RETAINED snapshot.
        pin = batch[0].pin_version
        use_mat = True
        with self._lock:
            if pin is not None:
                snap = self._version_params.get(pin)
                if snap is None:
                    # A write on another thread evicted the pin between the
                    # shed check and this snapshot — shed, don't fail.
                    raise StaleVersionError(pin, self._graph_version,
                                            self.cfg.max_staleness_versions)
                params, n_ent = snap
                gv = pin
            else:
                params, n_ent = self.params, self._n_entities
                gv = self._graph_version
            pv_served = self._params_version
            if self.cfg.pin_params_on_admit:
                # Serve on the params the batch was ADMITTED under; an
                # aged-out snapshot falls forward to current.
                pv = batch[0].params_version
                if pv != self._params_version and pv in self._params_by_version:
                    params, n_ent = self._params_by_version[pv]
                    pv_served = pv
                    use_mat = False
            mat_ver = (self.mat_cache.version
                       if self.mat_cache is not None else -1)
            lag = self._graph_version - gv if self.kg is not None else 0
        if self.sem_cache is not None:
            # Staging runs here, on the batcher thread, once per micro-batch:
            # the plan's store read + device copy, then the in-place apply,
            # both before the encode that gathers the rows.
            anchors = np.concatenate([q.anchors for q in padded])
            with TRACER.span("sem_prefetch", rows=len(anchors)):
                stage = self.sem_cache.plan(anchors)
            if stage is not None:
                self.sem_cache.apply_to(params, stage)
        enc = params
        if self._mesh is not None:
            # The whole parameters bar the entity rows (once a params set),
            # then this batch's anchor rows: collectives, in lane order.
            params = self._mesh.view(params)
            enc = self._mesh.encode_params(params, padded)
        with TRACER.span("encode", n=len(padded), graph_version=gv):
            states = self._states_for(enc, uniq, padded, n_real, mat_ver, gv,
                                      use_cache=use_mat)
        # The scores' copy to the host waits for the card: ``score`` ends only
        # once every launch before it has run.
        with TRACER.span("score", n=len(padded)):
            if self.sem_cache is not None:
                scores = self._scorer.chunked(params, states, self.sem_rows_fn)
            else:
                scores = self._scorer(params, states, n_ent).cpu().numpy()
        # Select per DISTINCT (row, k) group, not one k_max selection sliced
        # per request: argpartition at k_max can arrange boundary-tied ids
        # differently than argpartition at k, and the contract is exact
        # per-request equality with serve_batch(top_k=k).
        ks = scores.shape[1]
        with TRACER.span("select", n=len(batch)):
            sel_of: Dict[Tuple[int, int], np.ndarray] = {}
            for i, r in enumerate(batch):
                sel_of.setdefault((row_of[i], min(r.top_k, ks)), None)
            by_k: Dict[int, List[int]] = {}   # k -> unique computed rows
            for row, k in sel_of:
                by_k.setdefault(k, []).append(row)
            for k, rows in by_k.items():
                # Unique rows appear in ascending order, so the common
                # single-k group covers the contiguous prefix.
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
            if self.kg is not None:
                # Served counts by version lag (0 = current graph version).
                vc = self._version_served.get(lag)
                if vc is None:
                    vc = self._version_served[lag] = self._metrics.counter(
                        "version_lag_served", lag=str(lag))
                vc += len(batch)
            if self.cfg.record_batches:
                self.batch_log.append(BatchRecord(
                    queries=padded, n_real=n_real, flush=flush,
                    results=log_rows, params_version=pv_served))
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
        if self.mat_cache is not None:
            self.mat_cache.reset_counters()
        self._scorer_traces0 = self._scorer.traces
        self._sharing0 = dict(self.executor.sharing_stats())
        with self._lock:
            self._latency.reset()
            self._metrics.reset(only=[
                self._batches, self._batch_rows, self._padded_rows,
                self._coalesced, self._failures, self._stale_sheds,
                *self._flushes.values(), *self._version_served.values()])
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
            if self.cfg.pin_params_on_admit:
                out["params_version"] = self._params_version
            if self.kg is not None:
                out["graph_version"] = self._graph_version
                out["retained_versions"] = sorted(self._version_params)
                out["stale_sheds"] = int(self._stale_sheds)
                out["version_lag_served"] = {
                    lag: int(c) for lag, c in self._version_served.items()}
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
        if self.mat_cache is not None:
            # Duplicate-heavy traffic shows up here as the hit rate: rows
            # served without re-encoding since the last reset_counters.
            out["mat_cache"] = self.mat_cache.stats()
        return out
