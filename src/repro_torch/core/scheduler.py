"""Max-Fillness dynamic scheduler + eager-refcount slot allocation.

This is the paper's Algorithm 1 run AHEAD of device execution: the ready-set
loop, the Max-Fillness pool selection (Eq. 4), the cardinality equivalence
classes (Eq. 8), and the eager reference-counting reclamation rule (Eq. 7)
all execute verbatim — but their *output* is a static ``ExecutionSchedule``
whose pooled steps the executor then runs as gather → fused operator →
scatter on one workspace tensor. Eq. 7 therefore becomes host-side slot
liveness: a reclaimed tensor's workspace slot is pushed onto a free list and
reused by a later node, so peak-slot-count == the paper's peak memory.
"""
from __future__ import annotations

import dataclasses
import heapq
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core.ops import OpType
from repro_torch.core.querydag import BatchedDAG

# Pool key: (op_type, input_cardinality). Cardinality is the Eq. 8
# equivalence class; it is 0 for EMBED, 1 for PROJECT/NEGATE.
PoolKey = Tuple[int, int]


def bucket_size(n: int, b_max: int) -> int:
    """Pad pool sizes to powers of two (capped at b_max) so the set of
    schedule signatures — and hence encode closures — stays bounded. The cap
    applies to the PADDED size too: with a non-pow2 b_max, a pool of n ≤
    b_max rows whose next power of two exceeds b_max pads to b_max exactly
    (padded_n ≥ n always holds because the scheduler never forms a pool
    larger than b_max)."""
    if n >= b_max:
        return b_max
    p = 1
    while p < n:
        p <<= 1
    return min(p, b_max)


@dataclasses.dataclass
class PoolStep:
    """One fused kernel invocation: every node in the step is the same
    operator type and cardinality, drawn from arbitrary queries."""

    op: OpType
    cardinality: int
    node_ids: np.ndarray      # [n]
    in_slots: np.ndarray      # [n, cardinality] workspace rows to gather
    out_slots: np.ndarray     # [n] workspace rows to scatter
    rel_ids: np.ndarray       # [n] (PROJECT only, else zeros)
    anchor_ids: np.ndarray    # [n] (EMBED only, else zeros)
    padded_n: int             # bucketed size >= n

    @property
    def n(self) -> int:
        return len(self.node_ids)

    def signature(self) -> Tuple[int, int, int]:
        return (int(self.op), self.cardinality, self.padded_n)


@dataclasses.dataclass
class ExecutionSchedule:
    steps: List[PoolStep]
    n_slots: int              # peak workspace rows (refcount-reused)
    answer_slots: np.ndarray  # [n_queries]
    n_nodes: int              # without slot reuse the workspace would be this

    def signature(self) -> Tuple:
        return tuple(s.signature() for s in self.steps) + (self.padded_slots,)

    @property
    def padded_slots(self) -> int:
        return bucket_size(self.n_slots, 1 << 30)


class _SlotAllocator:
    """Free-list allocator implementing Eq. 7 as liveness analysis."""

    def __init__(self) -> None:
        self._free: List[int] = []
        self._next = 0
        self.peak = 0

    def alloc(self) -> int:
        if self._free:
            return heapq.heappop(self._free)
        s = self._next
        self._next += 1
        self.peak = self._next
        return s

    def release(self, slot: int) -> None:
        heapq.heappush(self._free, slot)


def schedule(
    dag: BatchedDAG,
    b_max: int = 512,
) -> ExecutionSchedule:
    """Algorithm 1 with Max-Fillness pool selection and eager slot reuse;
    pools pad to powers of two (``bucket_size``)."""
    n = dag.n_nodes
    indeg = np.array([len(inp) for inp in dag.inputs], dtype=np.int64)
    refcount = dag.n_consumers.copy()
    consumers: List[List[int]] = [[] for _ in range(n)]
    for i, inp in enumerate(dag.inputs):
        for j in inp:
            consumers[j].append(i)

    pools: Dict[PoolKey, List[int]] = {}
    order_hint: Dict[PoolKey, int] = {}

    def push(v: int) -> None:
        key = (int(dag.op[v]), len(dag.inputs[v]))
        pools.setdefault(key, []).append(v)
        order_hint.setdefault(key, len(order_hint))

    for v in np.nonzero(indeg == 0)[0]:
        push(int(v))

    alloc = _SlotAllocator()
    slot_of = np.full(n, -1, dtype=np.int64)
    steps: List[PoolStep] = []

    while pools:
        # Eq. 4: rho(tau) = |pool| / B_max; argmax with stable tie-break.
        key = max(pools, key=lambda k: (min(len(pools[k]), b_max), -order_hint[k]))
        nodes = pools[key]
        batch = nodes[:b_max]
        rest = nodes[b_max:]
        if rest:
            pools[key] = rest
        else:
            del pools[key]

        op = OpType(key[0])
        card = key[1]
        batch_arr = np.asarray(batch, dtype=np.int64)
        in_slots = np.zeros((len(batch), max(card, 1)), dtype=np.int64)
        for bi, v in enumerate(batch):
            for ci, j in enumerate(dag.inputs[v]):
                in_slots[bi, ci] = slot_of[j]
        out_slots = np.array([alloc.alloc() for _ in batch], dtype=np.int64)
        slot_of[batch_arr] = out_slots

        steps.append(
            PoolStep(
                op=op,
                cardinality=card,
                node_ids=batch_arr,
                in_slots=in_slots if card > 0 else np.zeros((len(batch), 1), np.int64),
                out_slots=out_slots,
                rel_ids=np.where(dag.rel[batch_arr] >= 0, dag.rel[batch_arr], 0),
                anchor_ids=np.where(dag.anchor[batch_arr] >= 0, dag.anchor[batch_arr], 0),
                padded_n=bucket_size(len(batch), b_max),
            )
        )

        # Eager reclamation (Eq. 7) + ready-set update (Alg. 1 lines 11-19).
        for v in batch:
            for j in dag.inputs[v]:
                refcount[j] -= 1
                if refcount[j] == 0:
                    alloc.release(int(slot_of[j]))
            for c in consumers[v]:
                indeg[c] -= 1
                if indeg[c] == 0:
                    push(c)

    return ExecutionSchedule(
        steps=steps,
        n_slots=alloc.peak,
        answer_slots=slot_of[dag.answer_node].copy(),
        n_nodes=n,
    )
