"""Online stochastic query sampler (App. F).

Queries are synthesized on-the-fly by BACKWARD ground-truth instantiation:
pick a (degree-weighted) answer entity, then walk the template DAG in reverse
assigning a witness entity to every node and drawing relations from actual
incoming edges — so accepted queries are non-empty by construction on the
positive part. Negation branches are grounded independently and validated by
rejection sampling against the symbolic oracle (P_accept ∝ 1[q ∈ Q_valid]).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Set, Tuple

import numpy as np

from repro_torch.core.ops import OpType
from repro_torch.core.patterns import TEMPLATES, QueryInstance, answer_query
from repro_torch.data.kg import KnowledgeGraph


@dataclasses.dataclass
class SampledQuery:
    query: QueryInstance
    answers: np.ndarray  # ground-truth answer ids on the training graph


class OnlineSampler:
    """The paper's App. F sampler: O(k·|B|) per batch, zero storage."""

    def __init__(
        self,
        kg: KnowledgeGraph,
        patterns: Sequence[str] = tuple(TEMPLATES),
        seed: int = 0,
        max_rejects: int = 32,
        max_answers: int = 512,
        degree_weighted: bool = True,
    ):
        self.kg = kg
        self.patterns = list(patterns)
        self.rng = np.random.default_rng(seed)
        self.max_rejects = max_rejects
        self.max_answers = max_answers
        self._in_indptr, self._in_rels, self._in_heads = kg.incoming_by_tail
        cand = kg.entities_with_incoming
        if degree_weighted:
            w = kg.degree[cand].astype(np.float64)
            self._answer_p = w / w.sum()
        else:
            self._answer_p = None
        self._answer_cand = cand
        self.stats = {"sampled": 0, "rejected": 0}

    # ------------------------------------------------------------- grounding
    def _random_incoming(self, ent: int) -> Optional[Tuple[int, int]]:
        lo, hi = self._in_indptr[ent], self._in_indptr[ent + 1]
        if hi <= lo:
            return None
        j = int(self.rng.integers(lo, hi))
        return int(self._in_rels[j]), int(self._in_heads[j])

    def _ground(self, pattern: str) -> Optional[QueryInstance]:
        tpl = TEMPLATES[pattern]
        n = len(tpl.nodes)
        ent = np.full(n, -1, dtype=np.int64)
        rel_of_node = np.full(n, -1, dtype=np.int64)
        target = int(self.rng.choice(self._answer_cand, p=self._answer_p))
        ent[tpl.answer_node] = target
        # Reverse walk: every node's witness entity is known before its inputs.
        for i in range(n - 1, -1, -1):
            node = tpl.nodes[i]
            if ent[i] < 0:
                # Unconstrained branch (e.g. the negated side): random witness.
                ent[i] = int(self.rng.choice(self._answer_cand, p=self._answer_p))
            if node.op == OpType.PROJECT:
                step = self._random_incoming(int(ent[i]))
                if step is None:
                    return None
                rel_of_node[i], ent[node.inputs[0]] = step
            elif node.op == OpType.INTERSECT:
                for j in node.inputs:
                    # Negated inputs stay unconstrained; positive inputs share
                    # the witness so the intersection is non-empty.
                    if tpl.nodes[j].op != OpType.NEGATE:
                        ent[j] = ent[i]
            elif node.op == OpType.UNION:
                k = node.inputs[int(self.rng.integers(len(node.inputs)))]
                ent[k] = ent[i]  # one branch witnesses; others stay random
            elif node.op == OpType.NEGATE:
                pass  # input grounded independently (stays -1 → random)
        anchors = np.array(
            [ent[i] for i, nd in enumerate(tpl.nodes) if nd.op == OpType.EMBED], dtype=np.int64
        )
        rels = np.array(
            [rel_of_node[i] for i, nd in enumerate(tpl.nodes) if nd.op == OpType.PROJECT],
            dtype=np.int64,
        )
        if (anchors < 0).any() or (rels < 0).any():
            return None
        return QueryInstance(pattern, anchors, rels)

    # ------------------------------------------------------------- sampling
    def sample(self, pattern: str) -> SampledQuery:
        for _ in range(self.max_rejects):
            self.stats["sampled"] += 1
            q = self._ground(pattern)
            if q is None:
                self.stats["rejected"] += 1
                continue
            ans = answer_query(self.kg, q)
            if not ans:  # rejection sampling: require non-empty answer set
                self.stats["rejected"] += 1
                continue
            ans_arr = np.fromiter(ans, dtype=np.int64)
            if len(ans_arr) > self.max_answers:
                ans_arr = self.rng.choice(ans_arr, self.max_answers, replace=False)
            return SampledQuery(q, ans_arr)
        raise RuntimeError(f"rejection sampling failed for pattern {pattern}")

    def sample_batch(
        self, batch_size: int, dist: Optional[Dict[str, float]] = None
    ) -> List[SampledQuery]:
        names = self.patterns
        if dist is None:
            p = None
        else:
            p = np.array([dist.get(n, 0.0) for n in names], dtype=np.float64)
            p = p / p.sum()
        picks = self.rng.choice(len(names), size=batch_size, p=p)
        return [self.sample(names[i]) for i in picks]

    # --------------------------------------------------------- train tensors
    def to_training_arrays(self, batch: List[SampledQuery], n_negatives: int):
        """(queries, positives [B], negatives [B,K]) — negatives are uniform
        corruptions filtered against the (sampled) answer set."""
        pos = np.array([b.answers[self.rng.integers(len(b.answers))] for b in batch])
        neg = self.rng.integers(0, self.kg.n_entities, size=(len(batch), n_negatives))
        for i, b in enumerate(batch):
            bad = np.isin(neg[i], b.answers)
            while bad.any():  # resample collisions (rare on sparse graphs)
                neg[i, bad] = self.rng.integers(0, self.kg.n_entities, bad.sum())
                bad = np.isin(neg[i], b.answers)
        return [b.query for b in batch], pos, neg
