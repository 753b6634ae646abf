"""Plan IR: the compiler's intermediate representation and its output.

The paper decouples logical operators from query topologies (§3); this module
is where a *batch* of query topologies becomes one shared program. A
``PlanGraph`` is a hash-consed operator DAG: every node is canonically
identified by ``(op, binding, child ids)``, so two queries whose subtrees are
structurally AND binding-wise identical (same anchor + relation chain — the
common case in 2p/3p/ip/pi workloads and in real serving traffic) point at
the SAME node. Construction (``compiler.build_plan``) interns nodes bottom-up,
which makes cross-query common-subexpression elimination a dictionary lookup
rather than a graph-isomorphism search.

``CompiledPlan`` is the fully lowered artifact every consumer executes:
the Max-Fillness schedule's static slot arrays, the per-batch bind arrays,
the per-query answer-slot map (duplicate answers alias the same slot — the
gather at the end of the encode fans one computed row out to every consuming
query, and gradients through shared nodes sum automatically in reverse mode),
plus a ``SharingReport`` quantifying what CSE bought.

Why CSE is semantically invisible (bitwise): every pooled operator is
row-wise — each output row depends only on that row's input rows, never on
the pool's composition or padded size — so a merged node computes exactly
the bits each duplicate would have computed, and consumers gather the same
values they would have produced locally. DESIGN.md §Compiler carries the
full argument. On the GPU the same holds for the port's kernels: every
pooled kernel computes each output row from that row's inputs alone, in an
order that does not depend on the pool.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class PlanNode:
    """One IR node. ``children`` are plan-node ids in template input order —
    deliberately NOT sorted: pooled intersect/union kernels reduce over the
    child axis in order, and commutative canonicalization could reorder a
    floating-point reduction, breaking the bitwise CSE-on == CSE-off
    contract. The canonical identity of a node is the full tuple
    ``(op, anchor, rel, children)`` (its hash-consing key)."""

    op: int                     # OpType value
    anchor: int                 # entity id for EMBED, else -1
    rel: int                    # relation id for PROJECT, else -1
    children: Tuple[int, ...]   # plan-node ids, template order

    def key(self) -> Tuple:
        return (self.op, self.anchor, self.rel, self.children)


@dataclasses.dataclass
class PlanGraph:
    """Deduplicated operator DAG for one canonically ordered query batch."""

    nodes: List[PlanNode]
    answer: np.ndarray          # [n_queries] plan-node id per query answer
    patterns: List[str]         # per-query pattern name (canonical order)
    nodes_before: int           # node count had no subexpression merged

    @property
    def n_nodes(self) -> int:
        return len(self.nodes)

    @property
    def n_queries(self) -> int:
        return len(self.answer)

    def topology_key(self) -> Tuple:
        """Hashable key of the POST-CSE shape, bindings excluded.

        The Max-Fillness schedule (and all slot index arrays) depends only on
        ``(op, children)`` per node plus the answer map — never on which
        entity/relation ids are bound — so two batches whose deduped DAGs
        coincide share one schedule-cache entry (and, after pow2 bucketing,
        usually one encode closure) even when their ids differ. Node ids are
        already canonical: interning assigns them in first-use order over the
        canonically sorted batch."""
        return (
            tuple((n.op, n.children) for n in self.nodes),
            tuple(self.answer.tolist()),
        )

    def consumer_counts(self) -> np.ndarray:
        """Eq. 7 refcount seeds on the MERGED graph: consumers are counted
        across every query that reaches a node (plus one scoring-head
        consumer per answer *reference*, so a slot aliased by k queries stays
        live until all k have been scored)."""
        counts = np.zeros(self.n_nodes, dtype=np.int64)
        for node in self.nodes:
            for j in node.children:
                counts[j] += 1
        for a in self.answer:
            counts[a] += 1
        return counts


@dataclasses.dataclass(frozen=True)
class SharingReport:
    """What cross-query subexpression sharing bought for one batch. Each
    merged node is one pooled row that is no longer computed in some
    (possibly padded) pool step, so ``pooled_rows_saved`` is the Eq. 5
    kernel-row reduction and peak slot liveness shrinks with it."""

    nodes_before: int           # one DAG node per query node (no sharing)
    nodes_after: int            # post-CSE node count

    @property
    def pooled_rows_saved(self) -> int:
        return self.nodes_before - self.nodes_after

    @property
    def saved_frac(self) -> float:
        return self.pooled_rows_saved / max(self.nodes_before, 1)


@dataclasses.dataclass
class CompiledPlan:
    """Everything the pooled encoder needs for one batch — the single
    artifact the serving engine and the offline ``serve_batch`` execute.

    ``signature`` keys encode CLOSURES (it only encodes bucketed shapes, so
    distinct structures may share one closure); ``structure_key`` keys the
    exact schedule — the post-CSE topology under CSE, the pattern multiset
    without — i.e. anything caching the schedule's ARRAYS must use it, not
    the coarser signature. ``answer_slots`` is the per-query answer map:
    entry i is the workspace row holding query i's answer state, and entries
    alias whenever queries share their full tree."""

    signature: Tuple
    structure_key: Tuple
    meta: Tuple[Tuple[int, int, int], ...]      # static (op, card, padded_n) per step
    slot_arrays: List[Dict[str, np.ndarray]]    # static per structure: in/out slots
    bind_arrays: List[Dict[str, np.ndarray]]    # per batch: anchor/rel ids
    answer_slots: np.ndarray                    # [n_queries] workspace rows
    n_slots_padded: int
    sched: object                               # scheduler.ExecutionSchedule
    patterns: List[str]
    order: np.ndarray                           # canonical order -> original order
    report: SharingReport

    def device_args(self, device):
        """Per-step ``{in_slots, out_slots, rel_ids, anchor_ids}`` and the
        answer slots as int64 tensors on ``device``. Every array goes over in
        ONE host-to-device copy of a packed buffer; the per-step tensors are
        views into it."""
        steps = [{**s, **b} for s, b in zip(self.slot_arrays, self.bind_arrays)]
        parts = [a.reshape(-1) for st in steps for a in st.values()]
        parts.append(self.answer_slots)
        flat = torch.from_numpy(np.concatenate(parts).astype(np.int64, copy=False))
        flat = flat.to(device)
        out, off = [], 0
        for st in steps:
            views = {}
            for k, a in st.items():
                views[k] = flat[off:off + a.size].view(a.shape)
                off += a.size
            out.append(views)
        return out, flat[off:]
