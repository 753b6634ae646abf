"""Plan-cache-affinity router with tenant admission.

The perf lever unique to this codebase is that everything expensive is
TOPOLOGY-keyed: schedules, plan-cache entries, materialized rows and encode
closures all key off the post-CSE ``PlanGraph.topology_key()``. So the
router's affinity rule is simply *rendezvous-hash the topology over the
live replica set*: identical topologies always land on the replica whose
caches already hold them, each replica's working set becomes a topology
partition that FITS its caches, and membership changes remap only ~1/N of
topologies (the rendezvous property — no ring, no token ceremony).

Layered on top:

* **Bounded load-aware spill** — pure affinity lets one hot topology build
  an unbounded queue on its home replica while neighbors idle. When the
  affinity target's queue depth exceeds ``spill_depth``, the request may
  spill to the next replica(s) in its rendezvous ranking (``spill_width``
  of them) — bounded, deterministic alternates, so a spilled topology
  warms at most ``1 + spill_width`` replicas rather than spraying the
  whole pool.
* **Per-tenant admission** — every request carries a tenant. Quotas bound
  a tenant's in-flight requests (``max_inflight``); priority classes
  decide who blocks under backpressure: a high-priority tenant waits in
  ``submit`` (the engine's bounded-queue contract), a low-priority tenant
  gets a typed :class:`ShedError` IMMEDIATELY whenever its target replica
  is at/over ``low_priority_depth`` or its admission would block — excess
  low-priority load is shed (typed, counted) instead of everyone queueing
  behind it.
* **Hot model swap** — ``router.update_params`` fans out through the pool;
  each engine stamps admissions with a params version and serves in-flight
  requests on the params they were admitted under (see ``engine.py``), so
  the swap is bit-safe without draining.

Telemetry: registry counters (``router_*``, and ``serving_*{tenant=}`` a
tenant), and, while ``obs.TRACER`` is enabled, a ``route`` span with
``pattern`` and ``tenant`` around each single request's placement and
admission (a shed there ends inside it).

All routing state is derived: the topology memo is a bounded LRU over
``QueryInstance.key()`` and the rendezvous rankings are memoized per
topology against the pool's ``membership_token``. Hashing uses blake2b,
not Python's salted ``hash()``, so placement is deterministic across
processes — a warm replica stays the home for its topologies across
restarts of the client.
"""
from __future__ import annotations

import dataclasses
import hashlib
import queue
import threading
import time
from collections import OrderedDict
from concurrent.futures import Future
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.core.compiler import build_plan
from repro_torch.core.patterns import QueryInstance
from repro_torch.obs.registry import get_registry
from repro_torch.obs.trace import TRACER
from repro_torch.serving.loadgen import latency_summary


class ShedError(RuntimeError):
    """Typed load-shed: the router refused admission WITHOUT blocking.

    ``reason`` is ``"quota"`` (tenant over its in-flight bound) or
    ``"backpressure"`` (low-priority tenant against a loaded replica).
    Clients distinguish shed from failure and may retry later; the router
    counts sheds per tenant and never lets them near ``failures``."""

    def __init__(self, tenant: str, reason: str, detail: str = ""):
        super().__init__(
            f"request shed for tenant {tenant!r}: {reason}"
            + (f" ({detail})" if detail else ""))
        self.tenant = tenant
        self.reason = reason


@dataclasses.dataclass(frozen=True)
class TenantSpec:
    """Admission contract for one tenant. ``max_inflight=0`` = unlimited."""

    name: str
    priority: str = "high"     # "high" blocks under load; "low" is shed
    max_inflight: int = 0

    def __post_init__(self):
        if self.priority not in ("high", "low"):
            raise ValueError(f"priority must be high|low, got {self.priority}")
        if self.max_inflight < 0:
            raise ValueError("max_inflight must be >= 0")


@dataclasses.dataclass
class RouterConfig:
    # Affinity target's queue depth above which a request may spill to the
    # next replica(s) in its rendezvous ranking.
    spill_depth: int = 8
    # How many rendezvous alternates a spilling request may consider. 0
    # disables spill (pure affinity).
    spill_width: int = 1
    # Queue depth at/above which a LOW-priority request is shed outright
    # (before even attempting a non-blocking enqueue). None = spill_depth.
    low_priority_depth: Optional[int] = None
    # Tenant used when submit() is called without one — keeps the router a
    # drop-in for single-engine call sites (loadgen's closed/open loops).
    default_tenant: str = "default"
    # Bounded memo of QueryInstance.key() -> topology_key.
    topo_memo_size: int = 4096


def query_topology_key(q: QueryInstance) -> Tuple:
    """Topology key of a single query: the post-CSE shape of its one-query
    plan, bindings excluded — the same key the schedule/plan/encode caches use
    downstream, which is exactly what makes routing by it an affinity rule
    rather than a heuristic."""
    return build_plan([q]).topology_key()


def rendezvous_rank(topo: Tuple, rids: Sequence[int]) -> List[int]:
    """Replica ids ranked by highest-random-weight for this topology.

    blake2b over ``repr((topo, rid))`` — deterministic across processes and
    runs (``topology_key`` tuples are all ints, so ``repr`` is stable).
    Removing a replica promotes each of its topologies to the next rank
    WITHOUT moving anyone else (the ~1/N remap property the tests pin)."""
    def weight(rid: int) -> bytes:
        return hashlib.blake2b(repr((topo, rid)).encode(),
                               digest_size=8).digest()

    return sorted(rids, key=lambda rid: (weight(rid), rid), reverse=True)


class _Tenant:
    """Runtime admission state + labeled metrics for one TenantSpec."""

    def __init__(self, spec: TenantSpec):
        self.spec = spec
        self.inflight = 0
        # tenant= labeled keys (serving_submitted{tenant=gold}, ...); the
        # engines' unlabeled keys are untouched.
        g = get_registry().group("serving", tenant=spec.name)
        self.metrics = g
        self.submitted = g.counter("submitted")
        self.completed = g.counter("completed")
        self.failures = g.counter("failures")
        self.shed = {r: g.counter("shed", reason=r)
                     for r in ("quota", "backpressure")}
        self.latency = g.histogram("latency_ms")


class Router:
    """Affinity router over a :class:`ReplicaPool`.

    Duck-compatible with ``ServingEngine`` for the loadgen drivers:
    ``submit(query, top_k=..., timeout=...)`` returns the same future, and
    ``close``/``stats`` fan out. ``submit`` additionally takes ``tenant=``.
    """

    def __init__(self, pool, tenants: Optional[Sequence[TenantSpec]] = None,
                 cfg: Optional[RouterConfig] = None):
        self.pool = pool
        self.cfg = cfg or RouterConfig()
        if self.cfg.spill_depth < 0 or self.cfg.spill_width < 0:
            raise ValueError("spill_depth and spill_width must be >= 0")
        self._lock = threading.Lock()
        self._tenants: Dict[str, _Tenant] = {}
        for spec in tenants or ():
            if spec.name in self._tenants:
                raise ValueError(f"duplicate tenant {spec.name!r}")
            self._tenants[spec.name] = _Tenant(spec)
        # Anonymous traffic rides a high-priority unlimited default tenant
        # unless the caller configured one explicitly.
        if self.cfg.default_tenant not in self._tenants:
            self._tenants[self.cfg.default_tenant] = _Tenant(
                TenantSpec(self.cfg.default_tenant))
        # Router-level (unlabeled-by-tenant) counters.
        self._metrics = get_registry().group("router")
        self._routed = self._metrics.counter("routed")
        self._spilled = self._metrics.counter("spilled")
        self._shed_total = self._metrics.counter("shed")
        # key() -> topology LRU, and topology -> ranking memo tied to the
        # pool's membership_token (join/leave invalidates wholesale).
        self._topo_memo: "OrderedDict[Tuple, Tuple]" = OrderedDict()
        self._rank_memo: Dict[Tuple, List[int]] = {}
        self._rank_token = -1
        # Token-cached replica view: pool.replicas() copies its dict (it
        # must — membership can change under it), which is too expensive to
        # do twice per submit. Benign racy refresh: the swap is atomic and
        # idempotent, and a stale view is caught by the token check on the
        # NEXT access — same staleness window the copy itself has.
        self._view: Dict[int, object] = {}
        self._view_token = -1

    # ------------------------------------------------------------- placement
    def _replicas(self) -> Dict[int, object]:
        token = self.pool.membership_token
        if token != self._view_token:
            self._view = self.pool.replicas()
            self._view_token = token
        return self._view

    def _topology(self, q: QueryInstance) -> Tuple:
        key = q.key()
        with self._lock:
            topo = self._topo_memo.get(key)
            if topo is not None:
                self._topo_memo.move_to_end(key)
                return topo
        topo = query_topology_key(q)   # plan build outside the lock
        with self._lock:
            self._topo_memo[key] = topo
            self._topo_memo.move_to_end(key)
            while len(self._topo_memo) > self.cfg.topo_memo_size:
                self._topo_memo.popitem(last=False)
        return topo

    def _ranking(self, topo: Tuple) -> List[int]:
        token = self.pool.membership_token
        with self._lock:
            if token != self._rank_token:
                self._rank_memo.clear()
                self._rank_token = token
            rank = self._rank_memo.get(topo)
            if rank is None:
                rank = rendezvous_rank(topo, sorted(self.pool.replicas()))
                if not rank:
                    raise RuntimeError("replica pool is empty")
                self._rank_memo[topo] = rank
        return rank

    def _place(self, topo: Tuple) -> Tuple[int, bool, List[int]]:
        return self._place_ranked(self._ranking(topo))

    def _place_ranked(self, rank: List[int]) -> Tuple[int, bool, List[int]]:
        """Pick ``(rid, spilled, ranking)``: the affinity target unless its
        queue is past ``spill_depth`` AND a ranked alternate is below it.
        With spill disabled placement is PURE (topology -> rank[0]), so no
        queue depth is probed at all."""
        if self.cfg.spill_width == 0:
            return rank[0], False, rank
        replicas = self._replicas()
        rank = [rid for rid in rank if rid in replicas]
        if not rank:
            raise RuntimeError("replica pool is empty")
        primary = rank[0]
        depth = replicas[primary].queue_depth()
        if depth <= self.cfg.spill_depth:
            return primary, False, rank
        for rid in rank[1:1 + self.cfg.spill_width]:
            if replicas[rid].queue_depth() <= self.cfg.spill_depth:
                return rid, True, rank
        return primary, False, rank

    # ------------------------------------------------------------- admission
    def submit(self, query: QueryInstance, top_k: Optional[int] = None,
               timeout: Optional[float] = None,
               tenant: Optional[str] = None) -> Future:
        """Route + admit one request. High-priority tenants inherit the
        engine's blocking backpressure (or ``queue.Full`` with ``timeout``);
        low-priority tenants NEVER block — any admission that would wait
        raises :class:`ShedError` instead. Quota sheds are checked first and
        apply to every priority class."""
        name = tenant if tenant is not None else self.cfg.default_tenant
        t = self._tenants.get(name)
        if t is None:
            raise KeyError(f"unknown tenant {name!r} "
                           f"(configured: {sorted(self._tenants)})")
        spec = t.spec
        # One lock acquisition covers the quota check AND both placement
        # memos: at steady state (memo hits, live token) the full routing
        # decision happens here; any miss falls back to the cold helpers.
        key = query.key()
        token = self.pool.membership_token
        rank = None
        with self._lock:
            if spec.max_inflight and t.inflight >= spec.max_inflight:
                t.shed["quota"].inc()
                self._shed_total.inc()
                raise ShedError(name, "quota",
                                f"{t.inflight}/{spec.max_inflight} in flight")
            t.inflight += 1
            if token == self._rank_token:
                topo = self._topo_memo.get(key)
                if topo is not None:
                    self._topo_memo.move_to_end(key)
                    rank = self._rank_memo.get(topo)
        try:
            if rank is None:
                rank = self._ranking(self._topology(query))
            if TRACER.enabled:
                with TRACER.span("route", pattern=query.pattern, tenant=name):
                    fut, spilled = self._admit(query, rank, top_k, timeout,
                                               name, spec)
            else:
                fut, spilled = self._admit(query, rank, top_k, timeout, name,
                                           spec)
        except ShedError:
            with self._lock:
                t.inflight -= 1
            t.shed["backpressure"].inc()
            self._shed_total.inc()
            raise
        except BaseException:
            with self._lock:
                t.inflight -= 1
            raise
        t.submitted.inc()
        self._routed.inc()
        if spilled:
            self._spilled.inc()
        t0 = time.perf_counter()

        def _done(f: Future, t=t, t0=t0):
            with self._lock:
                t.inflight -= 1
            if f.exception() is not None:
                t.failures.inc()
            else:
                t.completed.inc()
                t.latency.observe((time.perf_counter() - t0) * 1e3)

        fut.add_done_callback(_done)
        return fut

    def _admit(self, query: QueryInstance, rank: List[int], top_k, timeout,
               name: str, spec: TenantSpec) -> Tuple[Future, bool]:
        """Placement + enqueue for one already-quota-checked request."""
        rid, spilled, _rank = self._place_ranked(rank)
        rep = self._replicas()[rid]
        if spec.priority == "low":
            shallow = (self.cfg.low_priority_depth
                       if self.cfg.low_priority_depth is not None
                       else self.cfg.spill_depth)
            if rep.queue_depth() >= shallow:
                raise ShedError(name, "backpressure",
                                f"replica {rid} depth >= {shallow}")
            try:
                return rep.submit(query, top_k=top_k, timeout=0), spilled
            except queue.Full:
                raise ShedError(name, "backpressure",
                                f"replica {rid} queue full") from None
        return rep.submit(query, top_k=top_k, timeout=timeout), spilled

    def submit_many(self, queries: Sequence[QueryInstance],
                    top_k: Optional[int] = None,
                    timeout: Optional[float] = None,
                    tenant: Optional[str] = None) -> List[Future]:
        """Batched admission: one quota check + one memoized placement pass
        under a single lock acquisition, then ONE grouped engine admission
        per home replica — per-request router/engine overheads amortize
        across the batch. Results and routing are identical to a ``submit``
        loop; the differences are admission granularity: the quota check is
        all-or-nothing for the batch (shed before anything is enqueued), and
        all requests in a home-replica group share one admission timestamp
        and params version. Low-priority tenants keep the per-request path —
        their shed contract is per query."""
        name = tenant if tenant is not None else self.cfg.default_tenant
        t = self._tenants.get(name)
        if t is None:
            raise KeyError(f"unknown tenant {name!r} "
                           f"(configured: {sorted(self._tenants)})")
        spec = t.spec
        if spec.priority == "low":
            return [self.submit(q, top_k=top_k, timeout=timeout, tenant=name)
                    for q in queries]
        n = len(queries)
        if n == 0:
            return []
        keys = [q.key() for q in queries]
        token = self.pool.membership_token
        ranks: List[Optional[List[int]]] = [None] * n
        with self._lock:
            if spec.max_inflight and t.inflight + n > spec.max_inflight:
                t.shed["quota"].inc()
                self._shed_total.inc()
                raise ShedError(
                    name, "quota",
                    f"{t.inflight}+{n} > {spec.max_inflight} in flight")
            t.inflight += n
            if token == self._rank_token:
                for i, key in enumerate(keys):
                    topo = self._topo_memo.get(key)
                    if topo is not None:
                        self._topo_memo.move_to_end(key)
                        ranks[i] = self._rank_memo.get(topo)
        t0 = time.perf_counter()

        def _done(f: Future, t=t, t0=t0):
            with self._lock:
                t.inflight -= 1
            if f.exception() is not None:
                t.failures.inc()
            else:
                t.completed.inc()
                t.latency.observe((time.perf_counter() - t0) * 1e3)

        futures: List[Optional[Future]] = [None] * n
        enqueued = 0
        try:
            groups: Dict[int, List[int]] = {}
            spilled = 0
            for i, q in enumerate(queries):
                rank = ranks[i]
                if rank is None:
                    rank = self._ranking(self._topology(q))
                rid, sp, _rank = self._place_ranked(rank)
                groups.setdefault(rid, []).append(i)
                spilled += sp
            replicas = self._replicas()
            for rid, idxs in groups.items():
                fs = replicas[rid].submit_many(
                    [queries[i] for i in idxs], top_k=top_k, timeout=timeout)
                for i, f in zip(idxs, fs):
                    futures[i] = f
                    f.add_done_callback(_done)
                enqueued += len(fs)
        except BaseException:
            # Futures already enqueued stay admitted (their callbacks own
            # their inflight slots); release only the never-enqueued rest.
            with self._lock:
                t.inflight -= n - enqueued
            raise
        t.submitted.inc(n)
        self._routed.inc(n)
        if spilled:
            self._spilled.inc(spilled)
        return futures

    # ------------------------------------------------------------- lifecycle
    def update_params(self, params) -> None:
        """Hot model swap across the pool (bit-safe, no drain; collective
        under a mesh, ``ReplicaPool.update_params``)."""
        self.pool.update_params(params)

    def close(self, drain: bool = True, timeout: float = 60.0) -> None:
        self.pool.close(drain=drain, timeout=timeout)

    def __enter__(self) -> "Router":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # --------------------------------------------------------------- metrics
    def tenant_inflight(self, name: str) -> int:
        with self._lock:
            return self._tenants[name].inflight

    def stats(self) -> Dict:
        pool = self.pool.stats()
        with self._lock:
            tenants = {
                name: {
                    "priority": t.spec.priority,
                    "max_inflight": t.spec.max_inflight,
                    "inflight": t.inflight,
                    "submitted": int(t.submitted),
                    "completed": int(t.completed),
                    "failures": int(t.failures),
                    "shed": {r: int(c) for r, c in t.shed.items()},
                    "latency_ms": latency_summary(t.latency.window_values()),
                }
                for name, t in self._tenants.items()
            }
        return {
            "routed": int(self._routed),
            "spilled": int(self._spilled),
            "shed": int(self._shed_total),
            "tenants": tenants,
            "pool": pool,
        }
