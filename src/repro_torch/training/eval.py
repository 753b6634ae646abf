"""Filtered ranking metrics (MRR / Hits@k) for predictive query answering."""
from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np
import torch

from repro_torch.core.patterns import QueryInstance, answer_query
from repro_torch.data.kg import KnowledgeGraph


def filtered_ranks(scores: np.ndarray, answers: np.ndarray) -> np.ndarray:
    """Rank of each answer with other answers filtered out. scores [E]."""
    order = np.argsort(-scores, kind="stable")
    rank_of = np.empty_like(order)
    rank_of[order] = np.arange(len(order)) + 1
    ans_ranks = rank_of[answers]
    # filter: subtract the number of *other* answers ranked above each answer
    sorted_ranks = np.sort(ans_ranks)
    filtered = sorted_ranks - np.arange(len(sorted_ranks))
    return filtered


@torch.no_grad()
def evaluate(
    model,
    params,
    executor,
    eval_kg: KnowledgeGraph,
    queries: Sequence[QueryInstance],
    train_kg: KnowledgeGraph = None,
    batch_size: int = 64,
    score_all_fn=None,
) -> Dict[str, float]:
    """Filtered MRR / Hits over the *full* graph answers, each batch encoded
    by ``executor.encode`` and scored by ``model.score_all`` (the ``scoring``
    kernel for GQE and ComplEx on the card). If ``train_kg`` is given,
    metrics are also split into easy (observed) vs hard (predictive) answers
    — the paper's A_obs vs A_miss distinction.

    ``score_all_fn(params, states)`` overrides the all-entity scorer: the
    semantic-store path passes ``lambda p, q: model.score_all_chunked(p, q,
    store.read_rows)`` so that evaluation streams H_sem from the store
    instead of needing it resident (the queries' anchors must be staged in
    the hot set first)."""
    score_all = score_all_fn or model.score_all
    mrr, h1, h3, h10, n = 0.0, 0.0, 0.0, 0.0, 0
    hard_mrr, hard_n = 0.0, 0
    per_pattern: Dict[str, List[float]] = {}
    for lo in range(0, len(queries), batch_size):
        chunk = list(queries[lo : lo + batch_size])
        states = executor.encode(params, chunk)
        scores = score_all(params, states)
        scores = np.asarray(scores.cpu() if torch.is_tensor(scores) else scores)
        for i, q in enumerate(chunk):
            full_ans = np.fromiter(answer_query(eval_kg, q), dtype=np.int64)
            if len(full_ans) == 0:
                continue
            ranks = filtered_ranks(scores[i], full_ans)
            rr = 1.0 / ranks
            mrr += rr.sum()
            h1 += (ranks <= 1).sum()
            h3 += (ranks <= 3).sum()
            h10 += (ranks <= 10).sum()
            n += len(ranks)
            per_pattern.setdefault(q.pattern, []).append(float(rr.mean()))
            if train_kg is not None:
                easy = answer_query(train_kg, q)
                hard = np.array([a for a in full_ans if a not in easy], dtype=np.int64)
                if len(hard):
                    hr = filtered_ranks(scores[i], full_ans)
                    mask = np.isin(np.sort(full_ans), hard)
                    hard_mrr += (1.0 / hr[mask]).sum()
                    hard_n += len(hard)
    out = {
        "mrr": mrr / max(n, 1),
        "hits@1": h1 / max(n, 1),
        "hits@3": h3 / max(n, 1),
        "hits@10": h10 / max(n, 1),
        "n": float(n),
    }
    if train_kg is not None and hard_n:
        out["hard_mrr"] = hard_mrr / hard_n
    for p, vals in per_pattern.items():
        out[f"mrr/{p}"] = float(np.mean(vals))
    return out
