"""The program's ``ServingEngine`` on one device, serving the configuration's
model family with the benchmark's weights loaded through the program's
public loader. Every ``ModelConfig`` field the configuration gives and
every ``ServingConfig`` field the traffic mix gives is passed on.
"""
from __future__ import annotations

import dataclasses

import numpy as np


def load_into_port(cfg: dict, weights, n_entities: int, device):
    """The program's model of the configuration's family, with every
    ``ModelConfig`` field the configuration gives, and ``weights`` loaded
    through the program's public loader. Returns (model, params)."""
    from repro_torch.models.base import ModelConfig, make_model, params_from_numpy

    fields = {f.name for f in dataclasses.fields(ModelConfig)}
    model = make_model(cfg["model"], ModelConfig(**{k: v for k, v in cfg.items()
                                                    if k in fields}), device=device)
    params = params_from_numpy(model, {k: v.cpu().numpy() for k, v in weights.items()},
                               device=device, n_entities=n_entities)
    return model, params


def serving_config(mix: dict):
    from repro_torch.serving.engine import ServingConfig

    fields = {f.name for f in dataclasses.fields(ServingConfig)}
    return ServingConfig(**{k: v for k, v in mix.items() if k in fields})


def to_program(q):
    from repro_torch.core.patterns import QueryInstance
    return QueryInstance(q.pattern, np.asarray(q.anchors, dtype=np.int64),
                         np.asarray(q.relations, dtype=np.int64))


class EngineSystem:
    def __init__(self, cell, graph, weights, pool, device):
        from repro_torch.serving.engine import ServingEngine

        self.mix = cell.mix
        self.queries = [to_program(q) for q in pool]
        self.model, self.params = load_into_port(cell.config, weights, graph.n_entities,
                                                 device)
        self.engine = ServingEngine(self.model, self.params, cfg=serving_config(cell.mix),
                                    device=device)

    def submit(self, i: int):
        return self.engine.submit(self.queries[i])

    def warm_up(self) -> None:
        """Each power-of-two micro-batch the batcher can form."""
        b = 1
        while b <= self.engine.cfg.max_batch:
            for f in [self.engine.submit(self.queries[j]) for j in range(b)]:
                f.result(timeout=600)
            b *= 2

    def reset_counters(self) -> None:
        self.engine.reset_counters()

    def stats(self) -> dict:
        return self.engine.stats()

    def close(self) -> None:
        self.engine.close()
        self.engine = self.model = self.params = None


def build(cell, graph, weights, pool, device) -> EngineSystem:
    return EngineSystem(cell, graph, weights, pool, device)
