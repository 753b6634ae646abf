"""The benchmark's frozen copy of the port's online query sampler (App. F).

The 14 EFO query templates, the symbolic answer oracle and the backward
ground-truth sampler draw the same numpy random stream as
``repro_torch.sampling.online.OnlineSampler`` on the same graph, so one seed
gives the same queries as ``repro_torch.serving.loadgen.make_workload``
(``tests/test_perfbench_frozen.py``). A query is ``(pattern, anchors,
relations)``; the harness hands it to the program as the program's own
query type.
"""
from __future__ import annotations

from typing import Dict, List, NamedTuple, Optional, Sequence, Set, Tuple

import numpy as np

EMBED, PROJECT, INTERSECT, UNION, NEGATE = "e", "p", "i", "u", "n"

# name -> nodes (op, inputs); EMBED nodes take anchors and PROJECT nodes
# relations in node order; the last node is the answer.
TEMPLATES: Dict[str, Tuple[Tuple[str, Tuple[int, ...]], ...]] = {
    "1p": (("e", ()), ("p", (0,))),
    "2p": (("e", ()), ("p", (0,)), ("p", (1,))),
    "3p": (("e", ()), ("p", (0,)), ("p", (1,)), ("p", (2,))),
    "2i": (("e", ()), ("e", ()), ("p", (0,)), ("p", (1,)), ("i", (2, 3))),
    "3i": (("e", ()), ("e", ()), ("e", ()), ("p", (0,)), ("p", (1,)), ("p", (2,)),
           ("i", (3, 4, 5))),
    "pi": (("e", ()), ("p", (0,)), ("p", (1,)), ("e", ()), ("p", (3,)), ("i", (2, 4))),
    "ip": (("e", ()), ("e", ()), ("p", (0,)), ("p", (1,)), ("i", (2, 3)), ("p", (4,))),
    "2u": (("e", ()), ("e", ()), ("p", (0,)), ("p", (1,)), ("u", (2, 3))),
    "up": (("e", ()), ("e", ()), ("p", (0,)), ("p", (1,)), ("u", (2, 3)), ("p", (4,))),
    "2in": (("e", ()), ("e", ()), ("p", (0,)), ("p", (1,)), ("n", (3,)), ("i", (2, 4))),
    "3in": (("e", ()), ("e", ()), ("e", ()), ("p", (0,)), ("p", (1,)), ("p", (2,)),
            ("n", (5,)), ("i", (3, 4, 6))),
    "inp": (("e", ()), ("e", ()), ("p", (0,)), ("p", (1,)), ("n", (3,)), ("i", (2, 4)),
            ("p", (5,))),
    "pin": (("e", ()), ("p", (0,)), ("p", (1,)), ("e", ()), ("p", (3,)), ("n", (4,)),
            ("i", (2, 5))),
    "pni": (("e", ()), ("p", (0,)), ("p", (1,)), ("n", (2,)), ("e", ()), ("p", (4,)),
            ("i", (3, 5))),
}


class Query(NamedTuple):
    pattern: str
    anchors: Tuple[int, ...]
    relations: Tuple[int, ...]


def answer_query(kg, q: Query) -> Set[int]:
    """Set-semantics answers; a negation only ever feeds an intersection."""
    nodes = TEMPLATES[q.pattern]
    sets: List[Set[int]] = [set()] * len(nodes)
    negated = [False] * len(nodes)
    a_i = r_i = 0
    for i, (op, inputs) in enumerate(nodes):
        if op == EMBED:
            sets[i] = {int(q.anchors[a_i])}
            a_i += 1
        elif op == PROJECT:
            src = sets[inputs[0]]
            heads = (np.fromiter(src, dtype=np.int64) if src
                     else np.empty(0, np.int64))
            sets[i] = set(kg.neighbors_of_set(heads, int(q.relations[r_i])).tolist())
            r_i += 1
        elif op == NEGATE:
            sets[i] = sets[inputs[0]]
            negated[i] = True
        elif op == INTERSECT:
            pos = [sets[j] for j in inputs if not negated[j]]
            acc = set(pos[0])
            for s in pos[1:]:
                acc &= s
            for j in inputs:
                if negated[j]:
                    acc -= sets[j]
            sets[i] = acc
        else:  # UNION
            acc = set()
            for j in inputs:
                acc |= sets[j]
            sets[i] = acc
    return sets[-1]


class OnlineSampler:
    """Backward ground-truth instantiation with rejection of empty answers."""

    def __init__(self, kg, patterns: Sequence[str] = tuple(TEMPLATES), seed: int = 0,
                 max_rejects: int = 32, max_answers: int = 512):
        self.kg = kg
        self.patterns = list(patterns)
        self.rng = np.random.default_rng(seed)
        self.max_rejects = max_rejects
        self.max_answers = max_answers
        cand = kg.entities_with_incoming
        w = kg.degree[cand].astype(np.float64)
        self._answer_p = w / w.sum()
        self._answer_cand = cand

    def _random_incoming(self, ent: int) -> Optional[Tuple[int, int]]:
        lo, hi = self.kg.in_indptr[ent], self.kg.in_indptr[ent + 1]
        if hi <= lo:
            return None
        j = int(self.rng.integers(lo, hi))
        return int(self.kg.in_rels[j]), int(self.kg.in_heads[j])

    def _ground(self, pattern: str) -> Optional[Query]:
        nodes = TEMPLATES[pattern]
        n = len(nodes)
        ent = np.full(n, -1, dtype=np.int64)
        rel_of_node = np.full(n, -1, dtype=np.int64)
        ent[n - 1] = int(self.rng.choice(self._answer_cand, p=self._answer_p))
        for i in range(n - 1, -1, -1):
            op, inputs = nodes[i]
            if ent[i] < 0:
                ent[i] = int(self.rng.choice(self._answer_cand, p=self._answer_p))
            if op == PROJECT:
                step = self._random_incoming(int(ent[i]))
                if step is None:
                    return None
                rel_of_node[i], ent[inputs[0]] = step
            elif op == INTERSECT:
                for j in inputs:
                    if nodes[j][0] != NEGATE:
                        ent[j] = ent[i]
            elif op == UNION:
                k = inputs[int(self.rng.integers(len(inputs)))]
                ent[k] = ent[i]
        anchors = tuple(int(ent[i]) for i, (op, _) in enumerate(nodes) if op == EMBED)
        rels = tuple(int(rel_of_node[i]) for i, (op, _) in enumerate(nodes) if op == PROJECT)
        if min(anchors) < 0 or min(rels) < 0:
            return None
        return Query(pattern, anchors, rels)

    def sample(self, pattern: str) -> Query:
        for _ in range(self.max_rejects):
            q = self._ground(pattern)
            if q is None:
                continue
            ans = answer_query(self.kg, q)
            if not ans:
                continue
            if len(ans) > self.max_answers:
                # Drawn only to keep the random stream the port's.
                self.rng.choice(np.fromiter(ans, dtype=np.int64), self.max_answers,
                                replace=False)
            return q
        raise RuntimeError(f"rejection sampling failed for pattern {pattern}")

    def sample_batch(self, batch_size: int) -> List[Query]:
        picks = self.rng.choice(len(self.patterns), size=batch_size)
        return [self.sample(self.patterns[i]) for i in picks]
