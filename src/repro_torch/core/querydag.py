"""Batched QueryDAG construction (§4.1, "Graph Decomposition").

A mini-batch of queries with arbitrary mixed patterns is merged into one
global DAG; node ids are batch-global so operators from *different* queries
can later live in the same execution pool (cross-query operator fusion).
"""
from __future__ import annotations

import dataclasses
from typing import List, Sequence, Tuple

import numpy as np

from repro_torch.core.ops import OpType
from repro_torch.core.patterns import TEMPLATES, QueryInstance


@dataclasses.dataclass
class BatchedDAG:
    """Structure-of-arrays DAG for a query batch."""

    op: np.ndarray              # [n_nodes] int8 OpType
    rel: np.ndarray             # [n_nodes] int64, -1 if not PROJECT
    anchor: np.ndarray          # [n_nodes] int64, -1 if not EMBED
    query_id: np.ndarray        # [n_nodes] int64
    inputs: List[Tuple[int, ...]]   # per-node input node ids
    n_consumers: np.ndarray     # [n_nodes] refcount seed for Eq. 7
    answer_node: np.ndarray     # [n_queries] node id of each answer
    patterns: List[str]         # per-query pattern name

    @property
    def n_nodes(self) -> int:
        return len(self.op)

    @property
    def n_queries(self) -> int:
        return len(self.answer_node)

    def structure_key(self) -> Tuple:
        """Hashable multiset key: schedules depend only on the pattern
        multiset, so this keys the schedule cache."""
        names, counts = np.unique(np.array(self.patterns), return_counts=True)
        return tuple(zip(names.tolist(), counts.tolist()))


def build_batched_dag(queries: Sequence[QueryInstance]) -> BatchedDAG:
    ops: List[int] = []
    rels: List[int] = []
    anchors: List[int] = []
    qids: List[int] = []
    inputs: List[Tuple[int, ...]] = []
    answers: List[int] = []
    patterns: List[str] = []

    for qi, q in enumerate(queries):
        tpl = TEMPLATES[q.pattern]
        base = len(ops)
        a_i = r_i = 0
        for node in tpl.nodes:
            ops.append(int(node.op))
            if node.op == OpType.EMBED:
                anchors.append(int(q.anchors[a_i]))
                a_i += 1
            else:
                anchors.append(-1)
            if node.op == OpType.PROJECT:
                rels.append(int(q.relations[r_i]))
                r_i += 1
            else:
                rels.append(-1)
            qids.append(qi)
            inputs.append(tuple(base + j for j in node.inputs))
        answers.append(base + tpl.answer_node)
        patterns.append(q.pattern)

    n = len(ops)
    n_consumers = np.zeros(n, dtype=np.int64)
    for inp in inputs:
        for j in inp:
            n_consumers[j] += 1
    # Answer nodes have one extra logical consumer: the scoring head. This
    # keeps their slots live through the end of the schedule (Eq. 7).
    for a in answers:
        n_consumers[a] += 1

    return BatchedDAG(
        op=np.asarray(ops, dtype=np.int8),
        rel=np.asarray(rels, dtype=np.int64),
        anchor=np.asarray(anchors, dtype=np.int64),
        query_id=np.asarray(qids, dtype=np.int64),
        inputs=inputs,
        n_consumers=n_consumers,
        answer_node=np.asarray(answers, dtype=np.int64),
        patterns=patterns,
    )
