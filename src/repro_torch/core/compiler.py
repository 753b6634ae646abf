"""Query-plan compiler: canonicalize → CSE → Max-Fillness lowering.

Sits between ``patterns.py``/``querydag.py`` (the logical layer) and
``scheduler.py`` (Algorithm 1), and is the one place the whole engine turns
a query batch into an executable ``CompiledPlan``:

1. **Canonicalize** — sort the batch by the full query key (pattern, anchors,
   relations). Batches that are permutations of each other now produce the
   identical node numbering, so their topology keys — and schedule-cache
   entries — coincide. The ``order`` permutation is carried in the plan and
   inverted by callers that need original order.
2. **CSE** (``build_plan``) — intern every subquery bottom-up by its
   canonical identity ``(op, binding, child ids)``. Identical subtrees
   across ALL queries in the batch collapse to one node with multi-consumer
   fan-out; Eq. 7 refcounts then count consumers across queries, so slot
   liveness — and peak workspace memory — shrinks with sharing.
3. **Lower** — run the unmodified Max-Fillness scheduler on the merged DAG
   and pad its slot arrays; bind arrays (anchor/relation ids, the only
   batch-varying part) are rebuilt per batch via one vectorized gather over
   a precomputed index plan instead of per-step Python loops — this runs on
   the serving batcher thread every batch.

``cse=False`` is the ablation path (``--no-cse``): per-query nodes exactly
as ``build_batched_dag`` produces them, schedule cache keyed on the pattern
multiset. Both paths canonicalize by the full query key, so they order the
batch identically.

``PlanCache`` makes the whole pipeline above CROSS-BATCH: a repeated batch
(exact query-key tuple) skips steps 1-3 entirely, and a permutation of a
seen batch skips 2-3.

The host plan is numpy throughout and matches the JAX package's compiler
field by field (the port's tests hold it to exact equality).
"""
from __future__ import annotations

import collections
import dataclasses
import threading
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.ops import OpType
from repro_torch.core.patterns import TEMPLATES, QueryInstance
from repro_torch.obs.registry import get_registry as _get_registry
from repro_torch.core.plan import CompiledPlan, PlanGraph, PlanNode, SharingReport
from repro_torch.core.querydag import BatchedDAG, build_batched_dag
from repro_torch.core.scheduler import ExecutionSchedule, schedule


def build_plan(queries: Sequence[QueryInstance]) -> PlanGraph:
    """Hash-consing CSE over a (canonically ordered) query batch.

    Children are interned before their parents (template nodes are listed in
    topological order), so a node's canonical key can use child *ids* —
    structural equality of whole subtrees reduces to one tuple comparison,
    and the merge is O(total nodes) dictionary operations."""
    intern: Dict[Tuple, int] = {}
    nodes: List[PlanNode] = []
    answers: List[int] = []
    patterns: List[str] = []
    nodes_before = 0
    for q in queries:
        tpl = TEMPLATES[q.pattern]
        ids: List[int] = []
        a_i = r_i = 0
        nodes_before += len(tpl.nodes)
        for node in tpl.nodes:
            anchor = rel = -1
            if node.op == OpType.EMBED:
                anchor = int(q.anchors[a_i])
                a_i += 1
            elif node.op == OpType.PROJECT:
                rel = int(q.relations[r_i])
                r_i += 1
            pn = PlanNode(int(node.op), anchor, rel,
                          tuple(ids[j] for j in node.inputs))
            nid = intern.get(pn.key())
            if nid is None:
                nid = len(nodes)
                intern[pn.key()] = nid
                nodes.append(pn)
            ids.append(nid)
        answers.append(ids[tpl.answer_node])
        patterns.append(q.pattern)
    return PlanGraph(
        nodes=nodes,
        answer=np.asarray(answers, dtype=np.int64),
        patterns=patterns,
        nodes_before=nodes_before,
    )


def plan_to_dag(plan: PlanGraph) -> BatchedDAG:
    """Lower the merged IR into the scheduler's structure-of-arrays DAG.
    ``query_id`` is -1 throughout: a shared node belongs to several queries,
    and the scheduler never reads this field."""
    n = plan.n_nodes
    op = np.fromiter((nd.op for nd in plan.nodes), dtype=np.int8, count=n)
    rel = np.fromiter((nd.rel for nd in plan.nodes), dtype=np.int64, count=n)
    anchor = np.fromiter((nd.anchor for nd in plan.nodes), dtype=np.int64,
                         count=n)
    return BatchedDAG(
        op=op,
        rel=rel,
        anchor=anchor,
        query_id=np.full(n, -1, dtype=np.int64),
        inputs=[nd.children for nd in plan.nodes],
        n_consumers=plan.consumer_counts(),
        answer_node=plan.answer.copy(),
        patterns=list(plan.patterns),
    )


def _pad1(a: np.ndarray, n: int, fill: int) -> np.ndarray:
    out = np.full((n,), fill, dtype=np.int64)
    out[: len(a)] = a
    return out


def _pad2(a: np.ndarray, n: int, fill: int) -> np.ndarray:
    out = np.full((n, a.shape[1]), fill, dtype=np.int64)
    out[: len(a)] = a
    return out


class _BindPlan:
    """Precomputed index plan for the per-batch bind-array rebuild.

    The schedule's node order is static per structure; only the anchor and
    relation ids bound to those nodes change between batches. One gather of
    ``dag.rel``/``dag.anchor`` at ``gather_nodes`` plus one scatter into a
    flat padded buffer replaces the per-step Python loops that used to run
    on the scheduler thread every batch; per-step arrays are then zero-copy
    slices of the buffer."""

    def __init__(self, sched: ExecutionSchedule):
        spans: List[Tuple[int, int, int]] = []   # (offset, n_real, padded_n)
        off = 0
        for s in sched.steps:
            spans.append((off, s.n, s.padded_n))
            off += s.padded_n
        self.total = off
        self.spans = spans
        self.gather_nodes = (
            np.concatenate([s.node_ids for s in sched.steps])
            if sched.steps else np.empty(0, dtype=np.int64))
        # flat positions of real rows inside the padded buffer
        self.pad_pos = (
            np.concatenate([o + np.arange(n, dtype=np.int64)
                            for o, n, _ in spans])
            if spans else np.empty(0, dtype=np.int64))

    def bind(self, rel: np.ndarray, anchor: np.ndarray
             ) -> List[Dict[str, np.ndarray]]:
        rel_flat = np.zeros(self.total, dtype=np.int64)
        anc_flat = np.zeros(self.total, dtype=np.int64)
        # clip(min=0): non-PROJECT/EMBED nodes carry -1 and pool kernels read
        # the column unconditionally, same contract as the padded fill.
        rel_flat[self.pad_pos] = np.maximum(rel[self.gather_nodes], 0)
        anc_flat[self.pad_pos] = np.maximum(anchor[self.gather_nodes], 0)
        return [
            {"rel_ids": rel_flat[o:o + p], "anchor_ids": anc_flat[o:o + p]}
            for o, _, p in self.spans
        ]


class PlanCache:
    """Cross-batch compiled-plan cache, at two levels (both bounded LRU, one
    lock):

    * **exact** — keyed by the submission-order tuple of full query keys
      (plus the compile config). A hit skips everything: no canonicalize
      sort, no IR rebuild, no bind gathers.
    * **canonical** — keyed by the canonically sorted key tuple. A batch
      that is a permutation of a seen one hits here after paying only the
      canonicalize sort; the cached plan is reused with the new ``order``
      (everything else in a ``CompiledPlan`` is canonical-order data, so the
      arrays are shared, not copied).

    ``canonicalize_calls`` counts how often the canonicalize sort actually
    ran: it must NOT grow on exact hits. Plans depend only on the query keys
    and compile config, never on params or the KG, so entries are never
    invalidated.
    """

    def __init__(self, capacity: int = 256):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.capacity = capacity
        # Exact entries are cheap aliases (they share the canonical entry's
        # arrays), so the exact level gets 4x the canonical budget: many
        # submission orders of few canonical batches is the common shape.
        self._exact: "collections.OrderedDict" = collections.OrderedDict()
        self._canon: "collections.OrderedDict" = collections.OrderedDict()
        self._lock = threading.Lock()
        self._metrics = _get_registry().group("plan_cache")
        self.hits = self._metrics.counter("hits")
        self.misses = self._metrics.counter("misses")
        self.evictions = self._metrics.counter("evictions")
        self.canonicalize_calls = self._metrics.counter("canonicalize_calls")

    def _put(self, d, key, value, cap) -> None:
        d[key] = value
        d.move_to_end(key)
        while len(d) > cap:
            d.popitem(last=False)
            self.evictions += 1

    # ``compile_batch`` drives the two-level probe: ``get_exact`` counts only
    # hits (an exact miss falls through to the canonical probe, which settles
    # the lookup as hit or miss), and the canonicalize counter bumps exactly
    # when the sort ran — i.e. on every path past the exact level.
    def get_exact(self, key) -> Optional[CompiledPlan]:
        with self._lock:
            plan = self._exact.get(key)
            if plan is not None:
                self._exact.move_to_end(key)
                self.hits += 1
            return plan

    def get_canonical(self, key) -> Optional[CompiledPlan]:
        with self._lock:
            self.canonicalize_calls += 1
            plan = self._canon.get(key)
            if plan is not None:
                self._canon.move_to_end(key)
                self.hits += 1
            else:
                self.misses += 1
            return plan

    def put_exact(self, key, plan: CompiledPlan) -> CompiledPlan:
        with self._lock:
            self._put(self._exact, key, plan, 4 * self.capacity)
        return plan

    def put(self, exact_key, canon_key, plan: CompiledPlan) -> CompiledPlan:
        with self._lock:
            self._put(self._canon, canon_key, plan, self.capacity)
            self._put(self._exact, exact_key, plan, 4 * self.capacity)
        return plan

    def __len__(self) -> int:
        return len(self._canon)

    @property
    def hit_rate(self) -> float:
        n = int(self.hits) + int(self.misses)
        return int(self.hits) / n if n else 0.0

    def stats(self) -> Dict[str, float]:
        with self._lock:
            return {
                "name": "plan",
                "size": len(self._canon),
                "exact_size": len(self._exact),
                "capacity": self.capacity,
                "hits": int(self.hits),
                "misses": int(self.misses),
                "evictions": int(self.evictions),
                "hit_rate": self.hit_rate,
                "canonicalize_calls": int(self.canonicalize_calls),
            }

    def reset_counters(self) -> None:
        with self._lock:
            self._metrics.reset()

    def clear(self) -> None:
        with self._lock:
            self._exact.clear()
            self._canon.clear()


def compile_batch(
    queries: Sequence[QueryInstance],
    *,
    model_name: str,
    b_max: int = 512,
    reuse_slots: bool = True,
    policy: str = "max_fillness",
    cse: bool = True,
    sched_cache=None,
    plan_cache: Optional[PlanCache] = None,
    tile_policy=None,
    graph_version: int = -1,
) -> CompiledPlan:
    """Compile one query batch into a ``CompiledPlan``.

    ``sched_cache`` (a ``CompileCache``) memoizes the expensive half —
    Algorithm-1 scheduling, slot-array padding and the bind index plan — by
    ``structure_key``; a hit leaves only the two bind gathers per batch.
    ``plan_cache`` (a ``PlanCache``) sits in front of ALL of that: a batch
    whose exact query-key tuple was compiled before returns its plan with
    zero host work beyond building the key tuple.

    ``tile_policy`` (``autotune.PoolTilePolicy`` or None) switches pool
    padding to the kernel-aware rule (see ``scheduler.bucket_size``). Its
    ``key()`` is folded into BOTH cache keys: two executors holding
    different tunings never alias a schedule, so the signature universe
    stays closed per policy and steady-state signature misses stay at zero.

    ``graph_version`` (the KG's monotonic write counter; -1 = not pinned)
    enters ``cfg_key`` — the PLAN-cache key only, never the schedule-cache
    key — so a version-pinned query can never replay a plan admitted under
    a different graph state, while schedules (pure topology) still hit
    across writes and signature misses stay at zero through a write burst."""
    tile_key = tile_policy.key() if tile_policy is not None else ()
    cfg_key = (model_name, b_max, reuse_slots, policy, cse, tile_key,
               graph_version)
    exact_key = None
    if plan_cache is not None:
        exact_key = (tuple(q.key() for q in queries), cfg_key)
        plan = plan_cache.get_exact(exact_key)
        if plan is not None:
            return plan
    order = np.asarray(
        sorted(range(len(queries)), key=lambda i: queries[i].key()),
        dtype=np.int64)
    qs = [queries[i] for i in order]
    canon_key = None
    if plan_cache is not None:
        canon_key = (tuple(q.key() for q in qs), cfg_key)
        skel = plan_cache.get_canonical(canon_key)
        if skel is not None:
            plan = (skel if np.array_equal(skel.order, order)
                    else dataclasses.replace(skel, order=order))
            return plan_cache.put_exact(exact_key, plan)

    if cse:
        plan = build_plan(qs)
        n = plan.n_nodes
        # Bind sources come straight off the IR; the full scheduler DAG
        # (inputs lists, consumer counts) is only lowered on a cache MISS.
        rel = np.fromiter((nd.rel for nd in plan.nodes), np.int64, count=n)
        anchor = np.fromiter((nd.anchor for nd in plan.nodes), np.int64,
                             count=n)
        patterns = list(plan.patterns)
        report = SharingReport(nodes_before=plan.nodes_before,
                               nodes_after=n)
        key = ("cse",) + plan.topology_key() + (b_max, reuse_slots, policy,
                                                tile_key)
        lower = lambda: plan_to_dag(plan)  # noqa: E731
    else:
        dag = build_batched_dag(qs)
        rel, anchor, patterns = dag.rel, dag.anchor, dag.patterns
        report = SharingReport(nodes_before=dag.n_nodes,
                               nodes_after=dag.n_nodes)
        key = dag.structure_key() + (b_max, reuse_slots, policy, tile_key)
        lower = lambda: dag  # noqa: E731

    cached = sched_cache.get(key) if sched_cache is not None else None
    if cached is None:
        sched = schedule(lower(), b_max=b_max, reuse_slots=reuse_slots,
                         policy=policy, tile_policy=tile_policy)
        trash = sched.padded_slots
        meta = tuple(s.signature() for s in sched.steps)
        slot_arrays = [
            {
                "in_slots": _pad2(s.in_slots, s.padded_n, 0),
                "out_slots": _pad1(s.out_slots, s.padded_n, trash),
            }
            for s in sched.steps
        ]
        cached = (sched, meta, slot_arrays, trash, _BindPlan(sched))
        if sched_cache is not None:
            sched_cache.put(key, cached)
    sched, meta, slot_arrays, trash, bind_plan = cached

    out = CompiledPlan(
        signature=sched.signature() + (model_name,),
        structure_key=key,
        meta=meta,
        slot_arrays=slot_arrays,
        bind_arrays=bind_plan.bind(rel, anchor),
        answer_slots=sched.answer_slots,
        n_slots_padded=trash,
        sched=sched,
        patterns=patterns,
        order=order,
        report=report,
    )
    if plan_cache is not None:
        plan_cache.put(exact_key, canon_key, out)
    return out
