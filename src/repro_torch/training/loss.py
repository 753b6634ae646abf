"""Vectorized objective (Eq. 6): negative-sampling log-sigmoid ranking loss.

Scores are gamma - d(q, e); positives and K negatives are scored as one dense
[B, 1+K] block (the "vectorized logit formulation") rather than per-sample
lookups. Also returns the per-query loss vector for adaptive sampling."""
from __future__ import annotations

import torch
import torch.nn.functional as F


def negative_sampling_loss(model, params, q_states, pos_ids, neg_ids):
    """q_states [B, sd], pos_ids [B], neg_ids [B, K] -> (mean loss, per-query)."""
    cand = torch.cat([pos_ids[:, None], neg_ids], dim=1)    # [B, 1+K]
    scores = model.score_ids(params, q_states, cand)        # one fused block
    pos = scores[:, 0]
    neg = scores[:, 1:]
    per_query = -F.logsigmoid(pos) - F.logsigmoid(-neg).mean(dim=1)
    return per_query.mean(), per_query
