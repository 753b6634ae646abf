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
them."""
from __future__ import annotations

import threading
from typing import Dict, Sequence

import numpy as np
import torch

from repro_torch.core.compile_cache import CompileCache
from repro_torch.core.compiler import PlanCache, compile_batch
from repro_torch.core.ops import OpType
from repro_torch.core.patterns import QueryInstance
from repro_torch.core.plan import CompiledPlan
from repro_torch.device import resolve_device
from repro_torch.obs.registry import get_registry


class PooledExecutor:
    """Operator-level batching engine (the paper's contribution 1), on
    ``device`` (``cuda`` unless given)."""

    def __init__(self, model, b_max: int = 512, cse: bool = True, device=None):
        self.model = model
        self.b_max = b_max
        self.cse = cse
        self.device = resolve_device(device)
        self._sched_cache = CompileCache(128, name="schedule")
        self._encode_cache = CompileCache(128, name="encode")
        # Cross-batch plan cache: persists compiled plans across prepare()
        # calls so a repeated batch is one dict lookup. Plans never go stale
        # (keyed on query keys + compile config only).
        self._plan_cache = PlanCache(512)
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

    # ------------------------------------------------------------------ prep
    def prepare(self, queries: Sequence[QueryInstance]) -> CompiledPlan:
        """Thin wrapper over the plan compiler: canonicalize, CSE-merge
        shared subqueries (unless ``cse=False``), lower through the
        Max-Fillness scheduler, memoizing by deduped topology in the
        executor's schedule cache."""
        plan = compile_batch(
            queries, model_name=self.model.name, b_max=self.b_max,
            cse=self.cse, sched_cache=self._sched_cache,
            plan_cache=self._plan_cache)
        with self._stats_lock:
            self._nodes_before += plan.report.nodes_before
            self._nodes_after += plan.report.nodes_after
        return plan

    def sharing_stats(self) -> Dict:
        """Cumulative CSE effect over every batch this executor prepared,
        plus the cross-batch plan-cache counters."""
        with self._stats_lock:
            before, after = int(self._nodes_before), int(self._nodes_after)
        saved = before - after
        return {
            "nodes_before": before,
            "nodes_after": after,
            "pooled_rows_saved": saved,
            "saved_frac": saved / max(before, 1),
            "plan_cache": self._plan_cache.stats(),
        }

    # ---------------------------------------------------------------- encode
    def encode_fn(self, prepared: CompiledPlan):
        """Returns ``fn(params, steps, answer_slots) -> q_states`` for the
        plan's signature; structure is closed over, so one closure serves
        every batch of that signature."""
        key = prepared.signature
        fn = self._encode_cache.get(key)
        if fn is not None:
            return fn
        model = self.model
        meta = prepared.meta
        n_ws = prepared.n_slots_padded + 1  # +1 trash row for padding scatters
        device = self.device

        def encode(params, steps, answer_slots):
            ws = torch.ones((n_ws, model.state_dim), dtype=torch.float32,
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
                # In place: serving needs no gradient through the workspace,
                # and the gathers above copied every row this step reads.
                ws.index_copy_(0, arr["out_slots"], y)
            return ws[answer_slots]

        self._encode_cache.put(key, encode)
        return encode

    @torch.no_grad()
    def encode(self, params, queries: Sequence[QueryInstance]) -> torch.Tensor:
        """Query states [n, state_dim] in ORIGINAL query order."""
        prepared = self.prepare(queries)
        steps, ans = prepared.device_args(self.device)
        states = self.encode_fn(prepared)(params, steps, ans)
        inv = np.empty_like(prepared.order)
        inv[prepared.order] = np.arange(len(prepared.order))
        return states[torch.from_numpy(inv).to(self.device)]
