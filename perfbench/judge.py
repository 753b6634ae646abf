"""Whether the served answers are right: the plain reference recomputes a
seeded sample of them from the weights and queries the benchmark handed to
the program, in float64.

Two numbers are compared, each with its limit from the configuration file:

* ``score_gap``: the widest gap between a served score and the reference's
  score of the same entity, beyond the 5e-4 that the program's rounding of
  served scores to 3 decimals allows.
* ``rank_gap``: the widest gap by which the entity served at rank j lies
  below the reference's j-th best score. It is 0 when the served ids are
  the reference's top-k, and reads the score distance of any pair of
  entities whose order was swapped.

Every answered request, sampled or not, must also be well formed: top-k
distinct ids within the table, with as many finite scores.
"""
from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

# The program serves scores rounded to this many decimals.
DECIMALS = 3


def malformed(result: dict, top_k: int, n_entities: int) -> bool:
    ids, scores = result.get("top_entities"), result.get("scores")
    k = min(top_k, n_entities)
    return (not isinstance(ids, list) or not isinstance(scores, list) or len(ids) != k
            or len(scores) != k or len(set(ids)) != k
            or any(not 0 <= int(i) < n_entities for i in ids)
            or not np.all(np.isfinite(np.asarray(scores, dtype=np.float64))))


def gaps(ref_scores: torch.Tensor, answers: Sequence[Tuple[List[int], List[float]]]
         ) -> Dict[str, float]:
    """``score_gap`` and ``rank_gap`` of ``answers`` ((ids, scores) per row)
    against the reference's all-entity scores [n, E]."""
    ids = torch.tensor([a[0] for a in answers], device=ref_scores.device)
    served = torch.tensor([a[1] for a in answers], dtype=ref_scores.dtype,
                          device=ref_scores.device)
    at_ids = torch.gather(ref_scores, 1, ids)
    best = torch.topk(ref_scores, ids.shape[1], dim=1).values
    rounding = 0.5 * 10.0 ** -DECIMALS
    return {"score_gap": float(((served - at_ids).abs() - rounding).clamp_min(0).max()),
            "rank_gap": float((best - at_ids).clamp_min(0).max())}


def sample(n: int, size: int, seed: int) -> np.ndarray:
    """The indices of the answers the reference checks."""
    rng = np.random.default_rng([seed, 3])
    return np.sort(rng.choice(n, size=min(size, n), replace=False))


def control_answers(ref_scores: torch.Tensor, top_k: int) -> List[Tuple[List[int], List[float]]]:
    """Answers as the program serves them, from another side's scores: the
    top-k ids in descending order and their fp32 scores rounded to 3
    decimals."""
    s = ref_scores.float()
    top = torch.topk(s, min(top_k, s.shape[1]), dim=1)
    vals = np.round(top.values.cpu().numpy(), DECIMALS)
    return [(i.tolist(), v.tolist()) for i, v in zip(top.indices.cpu(), vals)]
