"""FuzzQE (Chen et al., 2022): fuzzy-logic query embeddings. States live in
[0,1]^d; intersection/union/negation are product t-norm / probabilistic sum /
complement — exactly the closed fuzzy-logic operators."""
from __future__ import annotations

import math

import torch

from repro_torch.models.base import QueryEncoder, clip, mlp_apply, mlp_params, register_model

_EPS = 1e-6


@register_model("fuzzqe")
class FuzzQE(QueryEncoder):
    @property
    def state_dim(self) -> int:
        return self.cfg.dim

    def init_geometry(self, generator, n_entities, n_relations):
        d, h = self.cfg.dim, self.cfg.dim * self.cfg.hidden_mult
        p = {"relation": torch.randn((n_relations, d), generator=generator,
                                     device=self.device) / math.sqrt(d)}
        p.update(mlp_params((2 * d, h, d), "proj", generator, self.device))
        return p

    def entity_state(self, params, ent_vec):
        return torch.sigmoid(ent_vec * 3.0)

    def _logit(self, x):
        x = clip(x, _EPS, 1.0 - _EPS)
        return torch.log(x) - torch.log1p(-x)

    def project(self, params, x, rel_ids):
        r = params["relation"][rel_ids]
        y = mlp_apply(params, "proj", torch.cat([self._logit(x), r], dim=-1), 2)
        return torch.sigmoid(y)

    def intersect(self, params, X):
        # Product t-norm, numerically as exp(sum log).
        return torch.exp(torch.log(clip(X, _EPS, 1.0)).sum(dim=1))

    def union(self, params, X):
        # Probabilistic sum: 1 - prod(1 - x).
        return 1.0 - torch.exp(torch.log(clip(1.0 - X, _EPS, 1.0)).sum(dim=1))

    def negate(self, params, x):
        return 1.0 - x

    def distance(self, params, q, ent_vec):
        e = self.entity_state(params, ent_vec)
        sim = (q * e).sum(dim=-1) / (
            torch.linalg.vector_norm(q, dim=-1) * torch.linalg.vector_norm(e, dim=-1) + _EPS)
        return (1.0 - sim) * math.sqrt(self.cfg.dim)
