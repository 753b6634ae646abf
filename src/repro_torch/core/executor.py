"""Pooled (operator-level) execution engine.

The pooled executor runs the host-computed ``ExecutionSchedule``: every
PoolStep is a gather → fused-operator kernel → scatter on a slot-reused
workspace tensor. Encode closures are cached by schedule signature in an LRU
``CompileCache`` with hit/miss counters; pool sizes are bucketed so the
signature set is small and — after warmup — every lookup hits, i.e. zero
signature-cache misses (``retraces``) in steady state. PyTorch runs eagerly,
so a closure is built, never compiled.

Batch preparation is delegated to the plan compiler (``core/compiler.py``):
``prepare`` canonicalizes the batch, merges identical subqueries across all
queries via CSE (``cse=False`` is the ablation path), lowers through the
Max-Fillness scheduler, and memoizes everything binding-independent by the
deduped topology — so each repeated structure only rebinds anchor/relation
ids, and shared subtrees are computed once for every query that consumes
them.

With a ``mat_cache`` (``core/matcache.py``) ``encode`` serves rows cached at
the current version, encodes only the misses and inserts them — the
inference paths only; a training step's encode closure never sees the
cache.

While ``obs.TRACER`` is on, ``encode``'s ``prepare`` runs in a ``plan`` span
(``scheduled``: 1 when it missed the schedule cache and ran the scheduler;
``plan_hit``: the plan cache's ``exact``, ``canonical`` or ``none``), and
its end is a device mark (``SpanTracer.device_mark``), which counts only
inside a device window the serving engine opened on the thread."""
from __future__ import annotations

import threading
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.core.compile_cache import CompileCache
from repro_torch.core.compiler import PlanCache, compile_batch
from repro_torch.core.matcache import index_tensor
from repro_torch.core.ops import OpType
from repro_torch.core.patterns import QueryInstance
from repro_torch.core.plan import CompiledPlan
from repro_torch.device import resolve_device
from repro_torch.distributed.context import ExecutionContext
from repro_torch.kernels.autotune import pool_tile_policy
from repro_torch.obs.registry import get_registry
from repro_torch.obs.trace import TRACER


class PooledExecutor:
    """Operator-level batching engine (the paper's contribution 1), on
    ``device`` (``cuda`` unless given).

    ``tile_policy`` makes pool padding kernel-aware (``kernels/autotune.py``
    ``PoolTilePolicy``, or None for pow2 padding). "auto" snapshots a policy
    from the process tuner AT CONSTRUCTION for this executor's device: the
    policy (and its cache-key contribution) is then fixed for the
    executor's lifetime, so its signature universe stays closed. With an
    untuned tuner the snapshot is None, and every plan is what it was
    without a tuner.

    ``ctx`` (a ``distributed.context.ExecutionContext``) is held for the
    trainer; under a mesh the executor runs on the rank's device (unless
    ``device`` names one) and each rank compiles the plan of its own slice
    of a batch's queries (``ctx.batch_rows``). The JAX package rounds the
    workspace up to a multiple of the DP size under a mesh
    (``src/repro/core/executor.py:159-170``) only so that GSPMD's batch
    constraint divides it; a per-rank plan has no such constraint, so the
    workspace is the single-device one."""

    def __init__(self, model, b_max: int = 512, reuse_slots: bool = True,
                 policy: str = "max_fillness", cse: bool = True, cache_size: int = 128,
                 device=None, mat_cache=None, tile_policy="auto", ctx=None,
                 plan_cache: Optional[PlanCache] = None, plan_cache_size: int = 512):
        self.ctx = ctx or ExecutionContext.single_device()
        if device is None:
            device = self.ctx.device
        self.model = model
        self.b_max = b_max
        self.reuse_slots = reuse_slots
        self.policy = policy
        self.cse = cse
        self.device = resolve_device(device)
        if tile_policy == "auto":
            tile_policy = pool_tile_policy(model, b_max=b_max, device=self.device)
        self.tile_policy = tile_policy
        self._sched_cache = CompileCache(cache_size, name="schedule")
        self._encode_cache = CompileCache(cache_size, name="encode")
        # Cross-batch plan cache: persists compiled plans across prepare()
        # calls so a repeated batch is one dict lookup. Plans never go stale
        # (keyed on query keys + compile config only). A given ``plan_cache``
        # is shared with whoever else holds it.
        self._plan_cache = plan_cache if plan_cache is not None else PlanCache(plan_cache_size)
        # Optional materialized-row cache consulted by encode() (inference
        # paths only: a constant row inside a gradient would detach its
        # subtree).
        self.mat_cache = mat_cache
        # Cumulative sharing-report totals across every prepared batch.
        self._exec_metrics = get_registry().group("executor")
        self._nodes_before = self._exec_metrics.counter("nodes_before")
        self._nodes_after = self._exec_metrics.counter("nodes_after")
        self._stats_lock = threading.Lock()

    def cache_stats(self) -> Dict[str, Dict[str, float]]:
        """Hit/miss/eviction counters for every SIGNATURE-keyed cache — the
        set whose misses define ``retraces``. The plan cache is deliberately
        absent: a plan-cache miss on fresh traffic re-runs host hash-consing
        but builds no closure (its counters live in ``sharing_stats``)."""
        return {"schedule": self._sched_cache.stats(),
                "encode": self._encode_cache.stats()}

    def reset_cache_counters(self) -> None:
        """Zero counters on every cache (contents kept) — e.g. after serving
        warmup so steady-state retraces are measured over traffic only."""
        for c in (self._sched_cache, self._encode_cache, self._plan_cache):
            c.reset_counters()
        if self.mat_cache is not None:
            self.mat_cache.reset_counters()

    # ------------------------------------------------------------------ prep
    def prepare(self, queries: Sequence[QueryInstance],
                graph_version: int = -1) -> CompiledPlan:
        """Thin wrapper over the plan compiler: canonicalize, CSE-merge
        shared subqueries (unless ``cse=False``), lower through the
        Max-Fillness scheduler, memoizing by deduped topology in the
        executor's schedule cache. ``graph_version`` (-1 = unpinned) is
        folded into the plan-cache key only — see ``compile_batch``."""
        plan = compile_batch(
            queries, model_name=self.model.name, b_max=self.b_max,
            reuse_slots=self.reuse_slots, policy=self.policy, cse=self.cse,
            sched_cache=self._sched_cache, plan_cache=self._plan_cache,
            tile_policy=self.tile_policy, graph_version=graph_version)
        with self._stats_lock:
            self._nodes_before += plan.report.nodes_before
            self._nodes_after += plan.report.nodes_after
        return plan

    def sharing_stats(self) -> Dict:
        """Cumulative CSE effect over every batch this executor prepared,
        plus the cross-batch reuse counters: ``plan_cache`` and, when
        attached, ``materialized``."""
        with self._stats_lock:
            before, after = int(self._nodes_before), int(self._nodes_after)
        saved = before - after
        out = {
            "nodes_before": before,
            "nodes_after": after,
            "pooled_rows_saved": saved,
            "saved_frac": saved / max(before, 1),
            "plan_cache": self._plan_cache.stats(),
        }
        if self.mat_cache is not None:
            out["materialized"] = self.mat_cache.stats()
        return out

    # ---------------------------------------------------------------- encode
    def encode_fn(self, prepared: CompiledPlan):
        """Returns ``fn(params, steps, answer_slots) -> q_states`` for the
        plan's signature; structure is closed over, so one closure serves
        every batch of that signature. Under autograd (grad mode on) the
        workspace is updated out of place, so gradients flow through every
        pool step, and reverse mode sums the per-query cotangents of a row
        that CSE shares between queries."""
        key = prepared.signature
        fn = self._encode_cache.get(key)
        if fn is not None:
            return fn
        model = self.model
        meta = prepared.meta
        n_ws = prepared.n_slots_padded + 1  # +1 trash row for padding scatters
        device = self.device

        def encode(params, steps, answer_slots):
            # The parameters' dtype: fp32, or fp64 where a check computes
            # the exact value to hold an fp32 step to.
            ws = torch.ones((n_ws, model.state_dim), dtype=params["entity"].dtype,
                            device=device)
            for (op, _card, _pn), arr in zip(meta, steps):
                op = OpType(op)
                if op == OpType.EMBED:
                    y = model.embed(params, arr["anchor_ids"])
                elif op == OpType.PROJECT:
                    y = model.project(params, ws[arr["in_slots"][:, 0]], arr["rel_ids"])
                elif op == OpType.NEGATE:
                    y = model.negate(params, ws[arr["in_slots"][:, 0]])
                elif op == OpType.INTERSECT:
                    y = model.intersect(params, ws[arr["in_slots"]])
                elif op == OpType.UNION:
                    y = model.union(params, ws[arr["in_slots"]])
                else:  # pragma: no cover
                    raise ValueError(op)
                if torch.is_grad_enabled():
                    ws = ws.index_copy(0, arr["out_slots"], y)
                else:
                    # In place: no gradient flows through the workspace,
                    # and the gathers above copied every row this step reads.
                    ws.index_copy_(0, arr["out_slots"], y)
            return ws[answer_slots]

        self._encode_cache.put(key, encode)
        return encode

    @torch.no_grad()
    def encode(self, params, queries: Sequence[QueryInstance],
               graph_version: int = -1) -> torch.Tensor:
        """Query states [n, state_dim] in ORIGINAL query order.

        With a ``mat_cache`` attached, rows cached at the CURRENT version are
        gathered from the cache and only the misses are encoded (then
        inserted back). The miss subset is padded to a power of two
        (repeating its last query) so varying hit counts cannot grow the
        signature set beyond what cache-off traffic produces. Pooled
        operators are row-wise, so the subset's rows are bitwise the rows the
        full batch would have produced.

        ``graph_version`` (-1 = unpinned) is folded into the materialized
        row keys and the plan-cache key, so a version-pinned replay can
        never be served a row admitted under a different graph state."""
        cache = self.mat_cache
        if cache is None or len(queries) == 0:
            return self._encode_fresh(params, queries, graph_version)
        return self.encode_cached(params, queries, cache, cache.version,
                                  graph_version)

    @torch.no_grad()
    def encode_cached(self, params, queries: Sequence[QueryInstance], cache,
                      version: int, graph_version: int = -1) -> torch.Tensor:
        """``encode`` through ``cache`` at a version the caller snapshotted
        with its params (the serving engine's path): rows stamped
        ``version`` are gathered, the misses encoded and inserted stamped
        ``version`` — dropped if the cache has moved on since."""
        keys = [q.key() if graph_version < 0 else q.key() + (graph_version,)
                for q in queries]
        hit, rows = cache.lookup_rows(keys, version=version)
        if len(hit) == len(queries):
            return rows
        hits = set(hit)
        miss = [i for i in range(len(queries)) if i not in hits]
        sub = [queries[i] for i in miss]
        sub = sub + [sub[-1]] * ((1 << (len(sub) - 1).bit_length()) - len(sub))
        fresh = self._encode_fresh(params, sub, graph_version)[: len(miss)]
        cache.insert([keys[i] for i in miss], fresh, version=version)
        if not hit:
            return fresh
        out = fresh.new_empty((len(queries), fresh.shape[1]))
        out.index_copy_(0, index_tensor(miss, self.device), fresh)
        out.index_copy_(0, index_tensor(hit, self.device), rows)
        return out

    def _traced_prepare(self, queries: Sequence[QueryInstance],
                        graph_version: int) -> CompiledPlan:
        """``prepare`` in a ``plan`` span, its outcome read off the caches'
        counters around it, then the device mark where the plan ends."""
        sched, plans = self._sched_cache, self._plan_cache
        misses, hits, canon = (int(sched.misses), int(plans.hits),
                               int(plans.canonicalize_calls))
        with TRACER.span("plan") as span:
            prepared = self.prepare(queries, graph_version=graph_version)
            if span is not None:
                hit = int(plans.hits) > hits
                span.args = {"scheduled": int(int(sched.misses) > misses),
                             "plan_hit": ("none" if not hit else "canonical"
                                          if int(plans.canonicalize_calls) > canon
                                          else "exact")}
        TRACER.device_mark("plan")
        return prepared

    def _encode_fresh(self, params, queries: Sequence[QueryInstance],
                      graph_version: int = -1) -> torch.Tensor:
        if TRACER.enabled:
            prepared = self._traced_prepare(queries, graph_version)
        else:
            prepared = self.prepare(queries, graph_version=graph_version)
        steps, ans = prepared.device_args(self.device)
        states = self.encode_fn(prepared)(params, steps, ans)
        inv = np.empty_like(prepared.order)
        inv[prepared.order] = np.arange(len(prepared.order))
        return states[torch.from_numpy(inv).to(self.device)]


class QueryLevelExecutor:
    """The baseline the paper beats: batching restricted to isomorphic query
    groups (KGReasoning/SQE-style). Each pattern group executes as its own
    fragmented sequence of kernels, so a mixed batch of |T| patterns issues
    ~|T|x more, ~|T|x smaller kernels.

    Exposes the same ``prepare`` / ``encode_fn`` / ``cache_stats`` surface as
    ``PooledExecutor`` (delegated to an inner engine with FIFO pools, slot
    reuse and no CSE); the per-pattern-group fragmentation lives in
    ``encode`` and the trainer's query-level step."""

    def __init__(self, model, b_max: int = 512, device=None, ctx=None):
        self.model = model
        # cse=False: the baseline frameworks never share work across queries
        # — leaving CSE on would quietly hand the baseline the paper's win.
        self._inner = PooledExecutor(model, b_max=b_max, reuse_slots=True,
                                     policy="fifo", cse=False, device=device, ctx=ctx)

    @property
    def ctx(self):
        return self._inner.ctx

    @property
    def device(self):
        return self._inner.device

    def prepare(self, queries: Sequence[QueryInstance]) -> CompiledPlan:
        """Schedule one (single-pattern) group — callers group first."""
        return self._inner.prepare(queries)

    def encode_fn(self, prepared: CompiledPlan):
        return self._inner.encode_fn(prepared)

    def cache_stats(self) -> Dict[str, Dict[str, float]]:
        return self._inner.cache_stats()

    def sharing_stats(self) -> Dict:
        return self._inner.sharing_stats()

    def reset_cache_counters(self) -> None:
        self._inner.reset_cache_counters()

    def prepare_groups(self, queries: Sequence[QueryInstance]):
        """``({pattern: queries}, {pattern: their indices})`` in order of
        first appearance."""
        groups: Dict[str, List[QueryInstance]] = {}
        idx: Dict[str, List[int]] = {}
        for i, q in enumerate(queries):
            groups.setdefault(q.pattern, []).append(q)
            idx.setdefault(q.pattern, []).append(i)
        return groups, idx

    @torch.no_grad()
    def encode(self, params, queries: Sequence[QueryInstance]) -> torch.Tensor:
        """Query states in ORIGINAL order, one fragment per pattern."""
        groups, idx = self.prepare_groups(queries)
        out = [None] * len(queries)
        for pat, qs in groups.items():
            states = self._inner.encode(params, qs)
            for j, i in enumerate(idx[pat]):
                out[i] = states[j]
        return torch.stack(out)
