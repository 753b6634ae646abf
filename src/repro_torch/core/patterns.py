"""The 14 EFO query patterns (§3.1) as operator-DAG templates.

A template is a tuple of node specs ``(op, inputs, negated_inputs)`` where
``inputs`` are indices of earlier nodes. EMBED nodes consume an anchor slot,
PROJECT nodes consume a relation slot (slots are assigned in template order).
The final node is the answer node.

Negation in these 14 patterns only ever feeds an intersection, so symbolic
answer evaluation treats NEGATE lazily: ``I(A, ¬B) = A \\ B``.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence, Set, Tuple

import numpy as np

from repro_torch.core.ops import OpType
from repro_torch.data.kg import KnowledgeGraph


@dataclasses.dataclass(frozen=True)
class NodeSpec:
    op: OpType
    inputs: Tuple[int, ...] = ()


@dataclasses.dataclass(frozen=True)
class QueryTemplate:
    name: str
    nodes: Tuple[NodeSpec, ...]

    @property
    def n_anchors(self) -> int:
        return sum(1 for n in self.nodes if n.op == OpType.EMBED)

    @property
    def n_relations(self) -> int:
        return sum(1 for n in self.nodes if n.op == OpType.PROJECT)

    @property
    def answer_node(self) -> int:
        return len(self.nodes) - 1

    @property
    def depth(self) -> int:
        d = [0] * len(self.nodes)
        for i, n in enumerate(self.nodes):
            d[i] = 1 + max((d[j] for j in n.inputs), default=0)
        return max(d)


def _t(name: str, *nodes: Tuple[OpType, Tuple[int, ...]]) -> QueryTemplate:
    return QueryTemplate(name, tuple(NodeSpec(op, tuple(inp)) for op, inp in nodes))


E, P, I, U, N = OpType.EMBED, OpType.PROJECT, OpType.INTERSECT, OpType.UNION, OpType.NEGATE

TEMPLATES: Dict[str, QueryTemplate] = {
    t.name: t
    for t in [
        _t("1p", (E, ()), (P, (0,))),
        _t("2p", (E, ()), (P, (0,)), (P, (1,))),
        _t("3p", (E, ()), (P, (0,)), (P, (1,)), (P, (2,))),
        _t("2i", (E, ()), (E, ()), (P, (0,)), (P, (1,)), (I, (2, 3))),
        _t("3i", (E, ()), (E, ()), (E, ()), (P, (0,)), (P, (1,)), (P, (2,)), (I, (3, 4, 5))),
        # pi: (e1 -r1-> x -r2-> y) AND (e2 -r3-> y)
        _t("pi", (E, ()), (P, (0,)), (P, (1,)), (E, ()), (P, (3,)), (I, (2, 4))),
        # ip: (e1 -r1-> x AND e2 -r2-> x) -r3-> y
        _t("ip", (E, ()), (E, ()), (P, (0,)), (P, (1,)), (I, (2, 3)), (P, (4,))),
        _t("2u", (E, ()), (E, ()), (P, (0,)), (P, (1,)), (U, (2, 3))),
        _t("up", (E, ()), (E, ()), (P, (0,)), (P, (1,)), (U, (2, 3)), (P, (4,))),
        _t("2in", (E, ()), (E, ()), (P, (0,)), (P, (1,)), (N, (3,)), (I, (2, 4))),
        _t(
            "3in",
            (E, ()), (E, ()), (E, ()),
            (P, (0,)), (P, (1,)), (P, (2,)),
            (N, (5,)), (I, (3, 4, 6)),
        ),
        # inp: ((e1 -r1-> x) AND NOT (e2 -r2-> x)) -r3-> y
        _t("inp", (E, ()), (E, ()), (P, (0,)), (P, (1,)), (N, (3,)), (I, (2, 4)), (P, (5,))),
        # pin: (e1 -r1-> x -r2-> y) AND NOT (e2 -r3-> y)
        _t("pin", (E, ()), (P, (0,)), (P, (1,)), (E, ()), (P, (3,)), (N, (4,)), (I, (2, 5))),
        # pni: NOT (e1 -r1-> x -r2-> y) AND (e2 -r3-> y)
        _t("pni", (E, ()), (P, (0,)), (P, (1,)), (N, (2,)), (E, ()), (P, (4,)), (I, (3, 5))),
    ]
}

PATTERN_NAMES: List[str] = list(TEMPLATES.keys())
NEGATION_PATTERNS = ("2in", "3in", "inp", "pin", "pni")
UNION_PATTERNS = ("2u", "up")
EVAL_PATTERNS = PATTERN_NAMES  # all 14 evaluated, as in the paper


@dataclasses.dataclass
class QueryInstance:
    """A grounded query: template + anchor entities + relation ids."""

    pattern: str
    anchors: np.ndarray  # [n_anchors] int64
    relations: np.ndarray  # [n_relations] int64

    def key(self) -> Tuple:
        # Memoized: the serving path hashes the same instance several times
        # (router placement, batch coalescing, materialized-cache keys) and
        # anchors/relations never mutate after grounding.
        k = getattr(self, "_key", None)
        if k is None:
            k = (self.pattern, tuple(self.anchors.tolist()),
                 tuple(self.relations.tolist()))
            self._key = k
        return k


def answer_query(kg: KnowledgeGraph, q: QueryInstance) -> Set[int]:
    """Symbolic (set-semantics) evaluation — the ground-truth oracle used by
    the sampler for rejection sampling and by tests as the logic oracle."""
    tpl = TEMPLATES[q.pattern]
    sets: List[Set[int]] = [set()] * len(tpl.nodes)
    negated: List[bool] = [False] * len(tpl.nodes)
    a_i = 0
    r_i = 0
    for i, node in enumerate(tpl.nodes):
        if node.op == OpType.EMBED:
            sets[i] = {int(q.anchors[a_i])}
            a_i += 1
        elif node.op == OpType.PROJECT:
            heads = np.fromiter(sets[node.inputs[0]], dtype=np.int64) if sets[node.inputs[0]] else np.empty(0, np.int64)
            sets[i] = set(kg.neighbors_of_set(heads, int(q.relations[r_i])).tolist())
            r_i += 1
        elif node.op == OpType.NEGATE:
            sets[i] = sets[node.inputs[0]]
            negated[i] = True
        elif node.op == OpType.INTERSECT:
            pos = [sets[j] for j in node.inputs if not negated[j]]
            neg = [sets[j] for j in node.inputs if negated[j]]
            acc = set(pos[0])
            for s in pos[1:]:
                acc &= s
            for s in neg:
                acc -= s
            sets[i] = acc
        elif node.op == OpType.UNION:
            acc = set()
            for j in node.inputs:
                acc |= sets[j]
            sets[i] = acc
    return sets[tpl.answer_node]
