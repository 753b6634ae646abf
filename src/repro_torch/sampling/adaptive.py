"""Adaptive (difficulty-weighted) online sampling — §4.3 / Fig. 9.

Maintains a per-pattern exponential moving average of training loss and tilts
the sampling distribution π toward currently-hard patterns, mixed with a
uniform floor for coverage. Under the paper's steered-workload protocol
(difficulty spikes every N steps) this tracks the shifted distribution instead
of waiting for the uniform sampler to catch up."""
from __future__ import annotations

from typing import Dict, Sequence

import numpy as np


class AdaptiveDistribution:
    def __init__(
        self,
        patterns: Sequence[str],
        ema: float = 0.9,
        temperature: float = 1.0,
        uniform_floor: float = 0.25,
    ):
        self.patterns = list(patterns)
        self.ema = ema
        self.temperature = temperature
        self.uniform_floor = uniform_floor
        self.difficulty: Dict[str, float] = {p: 1.0 for p in self.patterns}

    def update(self, pattern_losses: Dict[str, float]) -> None:
        for p, loss in pattern_losses.items():
            old = self.difficulty.get(p, 1.0)
            self.difficulty[p] = self.ema * old + (1.0 - self.ema) * float(loss)

    def distribution(self) -> Dict[str, float]:
        d = np.array([self.difficulty[p] for p in self.patterns], dtype=np.float64)
        z = (d - d.mean()) / (d.std() + 1e-6)
        w = np.exp(z / self.temperature)
        w = w / w.sum()
        u = np.full_like(w, 1.0 / len(w))
        w = (1.0 - self.uniform_floor) * w + self.uniform_floor * u
        return dict(zip(self.patterns, w.tolist()))


def pattern_losses_from_batch(patterns, per_query_loss) -> Dict[str, float]:
    """Aggregate per-query losses (host numpy) into per-pattern means."""
    per_query_loss = np.asarray(per_query_loss)
    out: Dict[str, float] = {}
    counts: Dict[str, int] = {}
    for p, l in zip(patterns, per_query_loss):
        out[p] = out.get(p, 0.0) + float(l)
        counts[p] = counts.get(p, 0) + 1
    return {p: out[p] / counts[p] for p in out}
