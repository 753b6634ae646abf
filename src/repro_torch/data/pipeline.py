"""The host side of a training step's input.

Holds ``batch_entity_ids``, the set of entity ids one step gathers semantic
rows for, which sync training stages into the hot-set cache before each
step. The rest of the JAX package's ``data/pipeline.py`` (the prefetching
batch pipeline and its work items) comes with pipelined training (slice 4).
"""
from __future__ import annotations

import numpy as np


def batch_entity_ids(queries, pos: np.ndarray, neg: np.ndarray) -> np.ndarray:
    """Every entity id one training step gathers semantic rows for: query
    anchors (EMBED pools) plus the positive/negative score candidates. This
    is the set the semantic hot-set cache must have staged before dispatch."""
    return np.concatenate(
        [np.asarray(q.anchors).ravel() for q in queries]
        + [np.asarray(pos).ravel(), np.asarray(neg).ravel()])
