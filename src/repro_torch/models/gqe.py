"""GQE (Hamilton et al., 2018): translational projection + DeepSets intersection."""
from __future__ import annotations

import math

import torch

from repro_torch.models.base import QueryEncoder, glorot, mlp_apply, mlp_params, register_model


@register_model("gqe")
class GQE(QueryEncoder):
    score_mode = "l1"  # score = gamma - |q - e|_1 == scoring kernel l1

    @property
    def state_dim(self) -> int:
        return self.cfg.dim

    def init_geometry(self, generator, n_entities, n_relations):
        d, h = self.cfg.dim, self.cfg.dim * self.cfg.hidden_mult
        p = {"relation": torch.randn((n_relations, d), generator=generator,
                                     device=self.device) / math.sqrt(d)}
        p.update(mlp_params((d, h, d), "int", generator, self.device))   # DeepSets phi
        p["int_out_w"] = glorot((d, d), generator, self.device)          # DeepSets rho
        p.update(mlp_params((d, h, d), "neg", generator, self.device))   # negation extension
        return p

    def entity_state(self, params, ent_vec):
        return ent_vec

    def project(self, params, x, rel_ids):
        return x + params["relation"][rel_ids]

    def intersect(self, params, X):
        h = mlp_apply(params, "int", X, 2)                  # [n, k, d]
        return h.mean(dim=1) @ params["int_out_w"]

    def union(self, params, X):
        # Smooth elementwise max — a permutation-invariant union surrogate.
        return torch.logsumexp(X * 4.0, dim=1) / 4.0

    def negate(self, params, x):
        return mlp_apply(params, "neg", x, 2)

    def distance(self, params, q, ent_vec):
        return (q - ent_vec).abs().sum(dim=-1)
